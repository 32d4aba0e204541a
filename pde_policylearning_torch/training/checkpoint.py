"""Checkpoints in torch's format and in the JAX package's `.msgpack`.

Counterpart of `pde_policylearning_tpu/training/checkpoint.py` (reference:
the torch.save / torch.load dictionaries across the training scripts,
run_pde_observers.py:313, libs/pino_utils/utils.py:156-195).

`save_checkpoint` / `load_checkpoint` go by the file's extension:
- `.pt`: torch's format, one file holding the module's
  `state_dict`, optionally the optimizer's and the scheduler's, and the
  epoch, read back with `weights_only=True`;
- `.msgpack`: the JAX package's format (flax's `serialization.to_bytes`),
  read and written with `msgpack` and numpy alone.  The tree is the flax
  parameter tree of the module (`utils.transplant.load_jax_params`,
  `jax_params`), a Trainer state `{'params', 'epoch', ...}` or a PINO
  resume blob `{'params', 'opt_state', 'done'}` (`load_jax_resume`).
Any other extension raises.  Orbax directories have no counterpart:
reading them needs JAX.

flax's msgpack layout: dicts keep their (string) keys, lists and tuples
become dicts keyed '0', '1', ...; an ndarray is the msgpack ext type 1
over the packed `(shape, dtype name, C-order bytes)`, a Python complex
ext type 2 over `(real, imag)`, a numpy scalar ext type 3 (an ndarray of
shape ()); an array over `MAX_CHUNK_SIZE` bytes becomes
`{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}`
of flat pieces.  numpy has no bfloat16: such a leaf is read into a
`torch.bfloat16` tensor with its bits exact, and a `torch.bfloat16`
tensor is written under the dtype name 'bfloat16'.
"""
from __future__ import annotations

import os

import msgpack
import numpy as np
import torch

from ..utils.transplant import (jax_param_keys, jax_params, load_jax_params,
                                load_jax_resume)

# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 byte limit on one
# object, less a margin
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _BFloat16Bits:
    """The uint16 bits of a bfloat16 array, between the file and torch."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    @property
    def nbytes(self):
        return self.bits.nbytes

    def tensor(self) -> torch.Tensor:
        return torch.from_numpy(self.bits.astype(np.uint16).view(np.int16)
                                .copy()).view(torch.bfloat16)


def _array_bytes(shape, name: str, buf: bytes) -> bytes:
    return msgpack.packb((tuple(shape), name, buf), use_bin_type=True)


def _array_from_bytes(data: bytes):
    shape, name, buf = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":
        return _BFloat16Bits(np.frombuffer(buf, np.uint16).reshape(shape))
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(
            x.shape, x.dtype.name, x.tobytes("C")))
    if isinstance(x, _BFloat16Bits):
        return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(
            x.bits.shape, "bfloat16", x.bits.tobytes("C")))
    if isinstance(x, np.generic):
        a = np.asarray(x)
        return msgpack.ExtType(_EXT_NPSCALAR, _array_bytes(
            a.shape, a.dtype.name, a.tobytes("C")))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    raise TypeError(f"save_msgpack: cannot write a {type(x).__name__}")


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _chunk(a):
    """flax's `_chunk`: flat pieces of at most MAX_CHUNK_SIZE bytes."""
    bits = isinstance(a, _BFloat16Bits)
    flat = (a.bits if bits else a).reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / flat.dtype.itemsize))
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    if bits:
        pieces = [_BFloat16Bits(p) for p in pieces]
    shape = a.bits.shape if bits else a.shape
    return {_CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _unchunk(d: dict):
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    pieces = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if pieces and isinstance(pieces[0], _BFloat16Bits):
        return _BFloat16Bits(np.concatenate([p.bits for p in pieces])
                             .reshape(shape))
    return np.concatenate(pieces).reshape(shape)


def _to_state(x):
    """flax's `to_state_dict` on plain containers, with torch tensors as
    numpy arrays and oversized arrays chunked."""
    if isinstance(x, dict):
        return {str(k): _to_state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _to_state(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        x = _BFloat16Bits(t.view(torch.int16).numpy().view(np.uint16)) \
            if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(x, (np.ndarray, _BFloat16Bits)) \
            and x.nbytes > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _from_state(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            x = _unchunk(x)
        else:
            return {k: _from_state(v) for k, v in x.items()}
    return x.tensor() if isinstance(x, _BFloat16Bits) else x


def save_msgpack(path: str, tree) -> str:
    """Write a tree of dicts, lists, tuples and leaves (torch tensors,
    numpy arrays and scalars, Python scalars and complex numbers) as flax
    writes it; its directory is made.  Returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack.packb(_to_state(tree), default=_ext_pack,
                         strict_types=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _adapt_dense_layout(raw, tgt):
    """Reconcile a legacy `{'tensor': (2, lead..., modes...)}` dense
    spectral leaf with the mode-major `{'mmK': (2, modes..., lead...)}`
    one (`ops/factorized.py:init_factorized`), in either direction, so
    that a checkpoint written before or after the layout change loads
    into `tgt`'s layout."""
    if not (isinstance(raw, dict) and isinstance(tgt, dict)):
        return raw
    mm_t = [k for k in tgt if k.startswith("mm")]
    if "tensor" in raw and len(raw) == 1 and len(mm_t) == 1:
        lead = int(mm_t[0][2:])
        a = raw["tensor"]
        perm = (0, *range(1 + lead, a.ndim), *range(1, 1 + lead))
        return {mm_t[0]: a.transpose(perm)}
    mm_r = [k for k in raw if k.startswith("mm")]
    if "tensor" in tgt and len(tgt) == 1 and len(mm_r) == 1:
        lead = int(mm_r[0][2:])
        a = raw[mm_r[0]]
        perm = (0, *range(a.ndim - lead, a.ndim), *range(1, a.ndim - lead))
        return {"tensor": a.transpose(perm)}
    return {k: _adapt_dense_layout(v, tgt.get(k)) if k in tgt else v
            for k, v in raw.items()}


def load_msgpack(path: str):
    """Read a flax `.msgpack` into nested dicts (lists and tuples as
    '0'-keyed dicts, as flax reads them without a target) of numpy arrays
    and scalars, a bfloat16 leaf as a `torch.bfloat16` tensor."""
    with open(path, "rb") as f:
        return _from_state(msgpack.unpackb(f.read(), ext_hook=_ext_unpack,
                                           raw=False))


def _lists(x):
    """'0'-keyed dicts (flax's lists and tuples) back to lists; flax
    module names are never all digits."""
    if isinstance(x, dict):
        if x and all(k.isdigit() for k in x) \
                and sorted(map(int, x)) == list(range(len(x))):
            return [_lists(x[str(i)]) for i in range(len(x))]
        return {k: _lists(v) for k, v in x.items()}
    return x


def _format(path: str) -> str:
    if path.endswith(".msgpack"):
        return "msgpack"
    if path.endswith(".pt"):
        return "torch"
    raise ValueError(f"checkpoint {path!r}: the extension names no format "
                     "(.msgpack: the JAX package's; .pt: torch's)")


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    scheduler=None, epoch: int = 0) -> str:
    """Write the module (and the optimizer, scheduler and epoch in torch's
    format) to `path`, its directory made, and return the path.  A
    `.msgpack` holds the flax parameter tree only (`{'params',
    'batch_stats'}` where the module has BatchNorm statistics), as the
    JAX package's entries write it."""
    if _format(path) == "msgpack":
        if optimizer is not None or scheduler is not None:
            raise ValueError(f"save_checkpoint {path!r}: a .msgpack holds "
                             "parameters only")
        params, stats = jax_params(model)
        return save_msgpack(path, params if stats is None else
                            {"params": params, "batch_stats": stats})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {"model": model.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    torch.save(state, path)
    return path


def _load_msgpack_into(path, model, optimizer, scheduler) -> int:
    raw = load_msgpack(path)
    if {"params", "opt_state", "done"} <= set(raw):
        return load_jax_resume(model, _lists(raw), optimizer, scheduler)
    if optimizer is not None or scheduler is not None:
        raise ValueError(f"load_checkpoint {path!r}: the file holds no "
                         "optimizer state")
    epoch, stats = 0, None
    if "params" in raw and set(raw) <= {"params", "batch_stats", "epoch",
                                        "opt_state"}:
        epoch = int(raw.get("epoch", 0))
        raw, stats = raw["params"], raw.get("batch_stats")
    params = _adapt_dense_layout(raw, jax_param_keys(model))
    load_jax_params(model, _lists(params), stats)
    return epoch


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    scheduler=None) -> int:
    """Fill `model` (and the optimizer and scheduler given) from a file of
    `save_checkpoint` or of the JAX package, each tensor on the device of
    what it fills; return the epoch (a resume blob's `done`)."""
    if _format(path) == "msgpack":
        return _load_msgpack_into(path, model, optimizer, scheduler)
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    return int(state["epoch"])
