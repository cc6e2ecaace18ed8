"""Opt-in decode paths that compute the same function as the default one
by another route; reached only through a constructor argument or a
direct call, never by default."""
