"""Seeded float32 weights of a configuration's RC-Net and SML, made on
the device, and the SML head's calibration by the reference.

The parameter tree is the reference's (`reference.chain.build_models` on
the meta device), which names every tensor as the system under test
does.  All normal draws come from one `torch.randn` call and all uniform
draws from one `torch.rand` call on a device generator seeded with the
run's seed; each tensor is a scaled slice of them.

- RC-Net: He-normal conv and linear weights (std sqrt(2 / fan_in)),
  biases 0.02 N(0, 1), BatchNorm scale 0.8 + 0.4 U, shift 0.1 N, running
  mean 0.1 N and variance 0.5 + U, LayerNorm scale 1 + 0.05 N and shift
  0.05 N: the port's `init_random_` scheme.
- SML: flax's default initialisers (LeCun normal, std sqrt(1 / fan_in) /
  0.8796, clipped at two deviations; zero biases; BatchNorm 1 / 0 with
  running statistics 0 / 1).  A He-normal SML is chaotic in bfloat16;
  this one is not.  Its head's last 1x1 conv is then set so that on the
  pool's first frame, run through the reference, its output has mean 0.1
  and deviation 0.02: scales near 1.1, as a trained SML's small
  corrections.  The head is the conv its reference class names
  (`reference.chain.sml_head`).

A tensor held directly by a module that is none of Conv2d, Linear,
BatchNorm2d and LayerNorm (a raw projection kernel, a bias table, a
layer-scale gamma, a token) takes the kind that the module's class
declares for it in `INIT`, {attribute name: kind}: one of `RAW_KINDS`
or ("normal", std).

- "w": the scheme's weight rule, its fan-in the numel of one row
  (t[0]: the second dimension of a 2-D kernel), as a Linear weight's;
- "w_t": the same rule on a transposed conv's (in, out, kh, kw) weight,
  its fan-in in * kh * kw;
- "b": the scheme's bias rule;
- "zeros", "ones";
- ("normal", std): std N(0, 1), not clipped.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from benchmark.reference.chain import Reference, build_models, decode, \
    f32_exact, sml_head

LECUN_TRUNC = 0.87962566103423978     # std of N(0, 1) cut at +-2
RAW_KINDS = ("w", "w_t", "b", "zeros", "ones")


def _plan(model: nn.Module):
    """(key, shape, kind, fan_in) of every state tensor."""
    out = []
    for mname, m in model.named_modules():
        for pname, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            key = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                kind = "w" if pname == "weight" else "b"
            elif isinstance(m, nn.BatchNorm2d):
                kind = "bn_" + pname
            elif isinstance(m, nn.LayerNorm):
                kind = "ln_" + pname
            else:
                kind = _declared(m, pname, key)
            if kind == "w_t":
                fan_in = t.shape[0] * t[0, 0].numel()
            else:
                fan_in = t[0].numel() if t.dim() > 1 else 1
            out.append((key, tuple(t.shape), kind, fan_in))
    return out


def _declared(m: nn.Module, pname: str, key: str):
    """The kind that `m`'s class declares in `INIT` for its own tensor
    `pname`: one of RAW_KINDS or ("normal", std); TypeError otherwise."""
    kind = getattr(m, "INIT", {}).get(pname)
    if kind not in RAW_KINDS and not (isinstance(kind, tuple)
                                      and len(kind) == 2
                                      and kind[0] == "normal"):
        raise TypeError(f"no initialiser for {key} of {type(m)}: {kind!r}")
    return kind


def _fill(plan, scheme: str, g: torch.Generator, device):
    """The state dict of `plan` under `scheme` ('he' or 'flax')."""
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in plan]
    total = sum(sizes)
    z = torch.randn(total, generator=g, device=device)
    u = torch.rand(total, generator=g, device=device)
    zc = z.clamp(-2.0, 2.0) if scheme == "flax" else z
    state, off = {}, 0
    for (key, shape, kind, fan_in), n in zip(plan, sizes):
        zn, un = zc[off:off + n].view(shape), u[off:off + n].view(shape)
        unclipped = z[off:off + n].view(shape)
        off += n
        if isinstance(kind, tuple):         # ("normal", std)
            state[key] = kind[1] * unclipped
            continue
        if kind in ("zeros", "ones"):
            state[key] = torch.full(shape, float(kind == "ones"),
                                    device=device)
            continue
        if kind == "bn_num_batches_tracked":
            state[key] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if scheme == "he":
            value = {"w": zn * (2.0 / fan_in) ** 0.5, "b": 0.02 * zn,
                     "bn_weight": 0.8 + 0.4 * un, "bn_bias": 0.1 * zn,
                     "bn_running_mean": 0.1 * zn,
                     "bn_running_var": 0.5 + un,
                     "ln_weight": 1.0 + 0.05 * zn, "ln_bias": 0.05 * zn}
        else:
            value = {"w": zn * (1.0 / fan_in) ** 0.5 / LECUN_TRUNC,
                     "b": 0.0 * zn, "bn_weight": 1.0 + 0.0 * zn,
                     "bn_bias": 0.0 * zn, "bn_running_mean": 0.0 * zn,
                     "bn_running_var": 1.0 + 0.0 * zn,
                     "ln_weight": 1.0 + 0.0 * zn, "ln_bias": 0.0 * zn}
        state[key] = value["w" if kind == "w_t" else kind].contiguous()
    return state


def make_weights(cfg: dict, seed: int, device, calibration_frame: Dict
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'rcnet': state, 'sml': state}, f32 on `device`, from `seed`; the
    SML head calibrated on `calibration_frame` (host frames, B = 1)."""
    rc_meta, sml_meta = build_models(cfg, device, meta=True)
    g = torch.Generator(device=device).manual_seed(seed)
    weights = {"rcnet": _fill(_plan(rc_meta), "he", g, device),
               "sml": _fill(_plan(sml_meta), "flax", g, device)}
    head = sml_head(sml_meta)
    head_w = weights["sml"][head + ".weight"]
    head_b = weights["sml"][head + ".bias"]
    head_b.zero_()
    ref = Reference(cfg, weights, device)
    with torch.no_grad(), f32_exact():
        image, mono, points, mask = decode(calibration_frame, device)
        x, d = ref.stage_inputs(image, mono, points, mask,
                                ref.rcnet_responses(image, points, mask))
        out = ref.sml.get_submodule(head)(ref.sml.head_input(x))
        mean, std = out.mean(), out.std()
        head_w.mul_(0.02 / std)
        head_b.fill_(0.1 - 0.02 * float(mean / std))
    return weights
