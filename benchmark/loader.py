"""A module of the benchmark loaded by the path of its file: the
harness's drivers and metric readers, and the reference's SML families
(`reference/sml/`)."""

from __future__ import annotations

import importlib.util


def load_file_module(path, name: str):
    """The module of file `path`, run under the name `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
