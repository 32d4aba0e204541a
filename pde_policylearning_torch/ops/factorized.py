"""Factorized complex tensors as dicts of real tensors.

Counterpart of `pde_policylearning_tpu/ops/factorized.py` (reference:
neuralop/models/spectral_convolution.py:15-140), same names, same stored
layouts:

* every leaf is a real tensor; a complex weight is stored with a leading
  axis of size 2 holding (real, imag), so optimizers and checkpoints need
  no complex support;
* dense weights are stored mode-major, `{'mmK': (2, m1..mN, lead...)}` with
  K leading (channel / layer) axes moved behind the modes; the legacy
  `{'tensor': (2, lead..., m1..mN)}` layout is understood everywhere.  For
  a 2-D conv the mode-major layout `(2, m1, m2, I, O)` is already the
  corner-contraction kernel's `(R, M2, I, O)` per corner
  (`ops/spectral_cuda.py`);
* `to_dense` always returns the logical `(lead..., m1..mN)` order.

Contractions take channels-last spectra `(batch, m1..mN, in_ch)`.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

_EINSUM_SYMBOLS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
# Disjoint alphabets for the einsum equations: mode axes lowercase (never
# 'i'/'o', which name channels), rank axes uppercase (never 'B', the batch).
_MODE_SYMS = "abcdefghjklmn"
_RANK_SYMS = "CDEFGHIJKLMNOPQRSTUVWXYZ"


def as_complex(w: torch.Tensor) -> torch.Tensor:
    """(2, ...) real tensor -> complex tensor (half-precision weights are
    upcast to float32 first)."""
    if w.dtype not in (torch.float32, torch.float64):
        w = w.float()
    return torch.complex(w[0], w[1])


def _real_pair(c: torch.Tensor) -> torch.Tensor:
    return torch.stack([c.real, c.imag])


def _normal_pair(generator, shape, std, dtype, device):
    """A (2, *shape) real tensor whose complex view has std `std`: real and
    imaginary parts each get std/sqrt(2) (torch's complex normal_, the
    reference spectral convs' init, spectral_convolution.py:223)."""
    return std / math.sqrt(2.0) * torch.randn(
        (2, *shape), generator=generator, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Rank resolution (tltorch semantics: a float rank is a fraction of the dense
# parameter count).
# ---------------------------------------------------------------------------

def tucker_rank(shape: Sequence[int], rank) -> tuple[int, ...]:
    if isinstance(rank, (tuple, list)):
        return tuple(int(r) for r in rank)
    if isinstance(rank, int):
        return tuple(min(rank, s) for s in shape)
    frac = float(rank) ** (1.0 / len(shape))
    return tuple(max(1, min(s, int(math.ceil(frac * s)))) for s in shape)


def cp_rank(shape: Sequence[int], rank) -> int:
    if isinstance(rank, int):
        return rank
    dense = int(np.prod(shape))
    return max(1, int(math.ceil(float(rank) * dense / sum(shape))))


def tt_rank(shape: Sequence[int], rank) -> tuple[int, ...]:
    order = len(shape)
    if isinstance(rank, (tuple, list)):
        return tuple(int(r) for r in rank)
    if isinstance(rank, int):
        return tuple([1] + [rank] * (order - 1) + [1])
    dense = int(np.prod(shape))
    r = max(1, int(math.sqrt(float(rank) * dense / sum(shape))))
    return tuple([1] + [r] * (order - 1) + [1])


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def init_factorized(generator, shape: Sequence[int],
                    factorization: str = "dense", rank=0.5,
                    std: float = 0.02, dtype=torch.float32,
                    n_lead: int = 2, device=None) -> dict:
    """Create the parameter dict of a factorized complex tensor, drawn from
    `generator` (a `torch.Generator`; None is the global one) on `device`
    (default: the generator's; with neither, the card, and it raises where
    there is none, as `resolve_device` does).

    `shape` is the dense complex shape, e.g. (in_ch, out_ch, m1, m2), with
    `n_lead` leading non-mode axes followed by the mode axes.
      dense : {'mmK': (2, modes..., lead...)}  (K = n_lead)
      tucker: {'core': (2, *ranks), 'factors': [(2, s_i, r_i), ...]}
      cp    : {'lambda': (2, R), 'factors': [(2, s_i, R), ...]}
      tt    : {'factors': [(2, r_i, s_i, r_{i+1}), ...]}
    """
    shape = tuple(int(s) for s in shape)
    factorization = (factorization or "dense").lower()
    if factorization.startswith("complex"):
        factorization = factorization[len("complex"):]
    order = len(shape)
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)

    def pair(sh, s):
        return _normal_pair(generator, sh, s, dtype, device)

    if factorization == "dense":
        n_lead = max(0, min(int(n_lead), order))
        t = pair(shape, std)
        if n_lead in (0, order):
            return {"tensor": t}
        perm = (0, *range(1 + n_lead, 1 + order), *range(1, 1 + n_lead))
        return {f"mm{n_lead}": t.permute(perm).contiguous()}
    if factorization == "tucker":
        ranks = tucker_rank(shape, rank)
        core = pair(ranks, std)
        return {"core": core,
                "factors": [pair((s, r), 1.0 / math.sqrt(r))
                            for s, r in zip(shape, ranks)]}
    if factorization == "cp":
        r = cp_rank(shape, rank)
        lam = pair((r,), std)
        return {"lambda": lam,
                "factors": [pair((s, r), 1.0 / math.sqrt(r)) for s in shape]}
    if factorization == "tt":
        ranks = tt_rank(shape, rank)
        return {"factors": [
            pair((ranks[i], s, ranks[i + 1]),
                 std ** (1.0 / order) / math.sqrt(ranks[i]))
            for i, s in enumerate(shape)]}
    raise ValueError(f"Unknown factorization: {factorization!r}")


def take_layer(params: dict, index: int) -> dict:
    """For jointly-factorized weights whose dense shape has a leading layer
    axis (joint_factorization, spectral_convolution.py:252-257): the weight
    dict of sub-tensor `index`.

    dense: slice the tensor; tucker/cp: slice the first factor's rows and
    keep the rest shared; tt: slice the first factor's middle axis."""
    kind = factorization_of(params)
    if kind == "dense":
        if "tensor" in params:
            return {"tensor": params["tensor"][:, index]}
        key, lead = _dense_mm_key(params)
        # stored (2, modes..., L, lead-1...): the layer axis is the first of
        # the trailing lead axes
        t = params[key]
        return {f"mm{lead - 1}": t.select(t.ndim - lead, index)}
    if kind == "tucker":
        core = as_complex(params["core"])
        row = as_complex(params["factors"][0])[index]            # (r0,)
        new_core = torch.tensordot(row, core, dims=([0], [0]))
        return {"core": _real_pair(new_core),
                "factors": list(params["factors"][1:])}
    if kind == "cp":
        f0 = as_complex(params["factors"][0])[index]             # (R,)
        return {"lambda": _real_pair(as_complex(params["lambda"]) * f0),
                "factors": list(params["factors"][1:])}
    f0 = as_complex(params["factors"][0])[:, index, :]           # (1, r1)
    merged = torch.einsum("ab,bsc->asc", f0,
                          as_complex(params["factors"][1]))
    return {"factors": [_real_pair(merged)] + list(params["factors"][2:])}


def _dense_mm_key(params: dict):
    """(key, n_lead) of a mode-major dense leaf, or (None, None)."""
    for k in params:
        if k.startswith("mm"):
            return k, int(k[2:])
    return None, None


def factorization_of(params: dict) -> str:
    if "tensor" in params or _dense_mm_key(params)[0] is not None:
        return "dense"
    if "core" in params:
        return "tucker"
    if "lambda" in params:
        return "cp"
    return "tt"


def to_dense(params: dict) -> torch.Tensor:
    """The full complex tensor in the logical `(lead..., m1..mN)` order (a
    view of the stored leaf for the dense layouts)."""
    kind = factorization_of(params)
    if kind == "dense":
        if "tensor" in params:
            return as_complex(params["tensor"])
        key, lead = _dense_mm_key(params)
        w = as_complex(params[key])                       # (modes..., lead...)
        return w.permute(*range(w.ndim - lead, w.ndim),
                         *range(w.ndim - lead))
    if kind == "tucker":
        core = as_complex(params["core"])
        factors = [as_complex(f) for f in params["factors"]]
        order = core.ndim
        core_syms = _EINSUM_SYMBOLS[:order]
        out_syms = _EINSUM_SYMBOLS[order:2 * order]
        operands = ",".join(o + c for o, c in zip(out_syms, core_syms))
        return torch.einsum(f"{core_syms},{operands}->{out_syms}", core,
                            *factors)
    if kind == "cp":
        lam = as_complex(params["lambda"])
        factors = [as_complex(f) for f in params["factors"]]
        out_syms = _EINSUM_SYMBOLS[:len(factors)]
        operands = ",".join(s + "Z" for s in out_syms)
        return torch.einsum(f"Z,{operands}->{out_syms}", lam, *factors)
    factors = [as_complex(f) for f in params["factors"]]
    out = factors[0]                                      # (1, s0, r1)
    for f in factors[1:]:
        out = torch.tensordot(out, f, dims=([-1], [0]))
    return out.squeeze(0).squeeze(-1)


def n_dense_params(shape: Sequence[int]) -> int:
    return 2 * int(np.prod(shape))


def n_params(params: dict) -> int:
    leaves = []
    for v in params.values():
        leaves.extend(v if isinstance(v, (list, tuple)) else [v])
    return sum(int(p.numel()) for p in leaves)


# ---------------------------------------------------------------------------
# Contractions with channels-last spectral input.
#
# x_ft: (batch, m1, ..., mN, in_ch) complex
# dense weight layout: (in_ch, out_ch, m1, ..., mN)  [separable: (in_ch, m..)]
# output: (batch, m1, ..., mN, out_ch)
# ---------------------------------------------------------------------------

def contract_dense(x_ft: torch.Tensor, weight: torch.Tensor,
                   separable: bool = False) -> torch.Tensor:
    modes = _MODE_SYMS[:x_ft.ndim - 2]
    if separable:
        return torch.einsum(f"B{modes}i,i{modes}->B{modes}i", x_ft, weight)
    return torch.einsum(f"B{modes}i,io{modes}->B{modes}o", x_ft, weight)


def contract_tucker(x_ft: torch.Tensor, params: dict,
                    separable: bool = False) -> torch.Tensor:
    core = as_complex(params["core"])
    factors = [as_complex(f) for f in params["factors"]]
    order = x_ft.ndim - 2
    modes = _MODE_SYMS[:order]
    ranks = _RANK_SYMS[:order + 2]
    if separable:
        core_syms = ranks[:order + 1]
        f_syms = ["i" + core_syms[0]] + [
            m + r for m, r in zip(modes, core_syms[1:])]
        out = "i"
    else:
        core_syms = ranks[:order + 2]
        f_syms = ["i" + core_syms[0], "o" + core_syms[1]] + [
            m + r for m, r in zip(modes, core_syms[2:])]
        out = "o"
    eq = f"B{modes}i,{core_syms},{','.join(f_syms)}->B{modes}{out}"
    return torch.einsum(eq, x_ft, core, *factors)


def contract_cp(x_ft: torch.Tensor, params: dict,
                separable: bool = False) -> torch.Tensor:
    lam = as_complex(params["lambda"])
    factors = [as_complex(f) for f in params["factors"]]
    modes = _MODE_SYMS[:x_ft.ndim - 2]
    lead = ["iZ"] if separable else ["iZ", "oZ"]
    f_syms = lead + [m + "Z" for m in modes]
    out = "i" if separable else "o"
    eq = f"B{modes}i,Z,{','.join(f_syms)}->B{modes}{out}"
    return torch.einsum(eq, x_ft, lam, *factors)


def contract_tt(x_ft: torch.Tensor, params: dict,
                separable: bool = False) -> torch.Tensor:
    factors = [as_complex(f) for f in params["factors"]]
    modes = _MODE_SYMS[:x_ft.ndim - 2]
    dims = ("i" + modes) if separable else ("io" + modes)
    ranks = _RANK_SYMS[:len(dims) + 1]
    f_syms = [ranks[k] + d + ranks[k + 1] for k, d in enumerate(dims)]
    out = "i" if separable else "o"
    eq = f"B{modes}i,{','.join(f_syms)}->B{modes}{out}"
    return torch.einsum(eq, x_ft, *factors)


def contract(x_ft: torch.Tensor, params: dict, separable: bool = False,
             implementation: str = "reconstructed") -> torch.Tensor:
    """Dispatch to the contraction for this weight dict (get_contract_fun,
    spectral_convolution.py:103).  Spectrum and dense weight meet in the
    wider of their two precisions."""
    kind = factorization_of(params)
    if implementation == "reconstructed" or kind == "dense":
        w = to_dense(params)
        dt = torch.promote_types(x_ft.dtype, w.dtype)
        return contract_dense(x_ft.to(dt), w.to(dt), separable=separable)
    fn = {"tucker": contract_tucker, "cp": contract_cp,
          "tt": contract_tt}[kind]
    return fn(x_ft, params, separable=separable)
