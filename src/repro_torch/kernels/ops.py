"""Dispatch over the hand-written Hopper kernels: the kernel-backend seam.

Every hot spot with a kernel is reached through one of these functions,
selected by a ``KernelBackend``:

- ``hopper`` launches the CUDA C++ kernels (``csrc/``) for sm_90a,
- ``ref`` serves the plain PyTorch oracles in ``repro_torch.kernels.ref``.

Selection mirrors ``repro.kernels.ops``: an explicit ``backend=``
argument, then the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable,
then the device of the tensors: a CUDA tensor resolves to ``hopper``, a
CPU tensor to ``ref``. There is no silent fallback. ``hopper`` on a CPU
tensor raises, and so does a CUDA card other than compute capability 9.0.
``ref`` runs on a CUDA tensor only when a caller asks for it explicitly;
nothing on the serving path does.

``LAUNCH_COUNTS`` counts real kernel launches by kernel name (the wrappers
bump it where they launch). ``DISPATCH_COUNTS`` counts which branch each
call took, ``*.hopper`` or ``*.ref``, so a run can show that no ``ref`` op
served it.
"""

from __future__ import annotations

import collections
import enum
import os
from typing import Optional, Union

import torch

from . import ref
from ._build import LAUNCH_COUNTS  # noqa: F401 (re-export)
from .flash_attention import flash_attention as _flash_hopper
from .grouped_matmul import grouped_matmul as _gmm_hopper
from .paged_attention import paged_attention as _paged_hopper


class KernelBackend(str, enum.Enum):
    """Which implementation a kernel dispatch executes."""

    REF = "ref"
    HOPPER = "hopper"


BACKEND_ENV = "REPRO_TORCH_KERNEL_BACKEND"

DISPATCH_COUNTS: collections.Counter = collections.Counter()

BackendSpec = Union[KernelBackend, str, None]


def record(branch: str) -> None:
    DISPATCH_COUNTS[branch] += 1


def reset_counts() -> None:
    """Zero ``DISPATCH_COUNTS`` and ``LAUNCH_COUNTS``."""
    DISPATCH_COUNTS.clear()
    LAUNCH_COUNTS.clear()


def default_backend(device) -> KernelBackend:
    """``hopper`` for a CUDA device, ``ref`` for the CPU."""
    return KernelBackend.HOPPER if torch.device(device).type == "cuda" else KernelBackend.REF


def resolve_backend(backend: BackendSpec = None, device="cpu") -> KernelBackend:
    """Normalize a backend spec for tensors on ``device``:
    None/"auto" -> environment variable -> device. Raises where the
    choice cannot run: ``hopper`` off CUDA, or on a card that is not sm_90."""
    if backend is None or backend == "auto":
        backend = os.environ.get(BACKEND_ENV) or default_backend(device)
    be = KernelBackend(backend)
    if be is KernelBackend.HOPPER:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"the hopper backend runs on CUDA tensors, got a {device.type} tensor; "
                "use backend='ref' on the CPU"
            )
        cap = torch.cuda.get_device_capability(device)
        if cap != (9, 0):
            raise RuntimeError(
                f"the hopper kernels are built for sm_90a (H100/H200); "
                f"{torch.cuda.get_device_name(device)} has compute capability {cap}"
            )
    return be


def attention(
    q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
    scale: Optional[float] = None, backend: BackendSpec = None,
) -> torch.Tensor:
    """(B, Hq, Sq, hd) x (B, Hkv, Sk, hd)^2 -> (B, Hq, Sq, hd)."""
    if resolve_backend(backend, q.device) is KernelBackend.HOPPER:
        record("attention.hopper")
        return _flash_hopper(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    record("attention.ref")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def flash_attention(
    q, k, v, *, is_global=True, window: int = 0, softcap: float = 0.0,
    scale: Optional[float] = None, backend: BackendSpec = None,
) -> torch.Tensor:
    """Causal full-sequence (prefill) attention in MODEL layout.

    q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd). ``window``
    applies only when ``is_global`` is false; the TPU seam chose with
    ``lax.cond`` on a traced flag, here it is a host-side branch.
    """
    B, S, Hq, hd = q.shape
    if resolve_backend(backend, q.device) is not KernelBackend.HOPPER:
        record("flash.ref")
        pos = torch.arange(S, dtype=torch.int32, device=q.device)
        return ref.decode_attend_ref(
            q, k, v, pos, pos, scale=hd**-0.5 if scale is None else scale,
            softcap=softcap, window=window, is_global=is_global,
        )
    record("flash.hopper")
    win = 0 if window <= 0 or bool(is_global) else window
    out = _flash_hopper(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=win, softcap=softcap, scale=scale,
    )
    return out.transpose(1, 2)  # the kernel wrote a (B, S, Hq, hd) buffer


def decode_attention(
    q, k_cache, v_cache, k_new, v_new, pos, *, block_tables=None,
    scale: Optional[float] = None, softcap: float = 0.0, window: int = 0,
    is_global=True, trash_block: int = 0, backend: BackendSpec = None,
):
    """One cache-appending decode/chunk attention step, either layout.

    q: (B, C, Hq, hd) rope'd queries; k_new/v_new: (B, C, Hkv, hd) the
    chunk's rope'd K/V; ``pos`` an int, a scalar tensor (lockstep) or a
    (B,) tensor of write positions. ``block_tables`` None means contiguous
    ``(B, Smax, Hkv, hd)`` caches, sent to the paged kernel as one page per
    row behind the identity table; otherwise shared ``(N, bs, Hkv, hd)``
    pages addressed through the ``(B, max_blocks)`` table. The caches are
    updated in place. Returns ``(out, k_cache, v_cache)``.
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if pos.ndim > 1:
        raise ValueError(f"pos must be a scalar or (B,) vector, got {tuple(pos.shape)}")
    B, C = q.shape[0], q.shape[1]
    if block_tables is None and C > 1 and pos.ndim != 0:
        raise ValueError(
            f"contiguous multi-token append is lockstep-only: a C={C} chunk needs a "
            f"scalar pos, got shape {tuple(pos.shape)}; pass block_tables for per-row chunks"
        )
    if resolve_backend(backend, q.device) is KernelBackend.HOPPER:
        record("decode.hopper")
        posv = torch.broadcast_to(pos.reshape(-1), (B,)).contiguous()
        tables = (
            torch.arange(B, dtype=torch.int32, device=q.device)[:, None]  # one page per row
            if block_tables is None
            else block_tables
        )
        return _paged_hopper(
            q, k_cache, v_cache, tables, k_new, v_new, posv, is_global,
            scale=scale, softcap=softcap, window=window,
        )
    if block_tables is not None:
        record("decode.ref_paged")
        return ref.paged_attention_ref(
            q, k_cache, v_cache, block_tables, k_new, v_new, pos, is_global,
            scale=scale, softcap=softcap, window=window, trash_block=trash_block,
        )
    record("decode.ref_append")
    return ref.append_attention_ref(
        q, k_cache, v_cache, k_new, v_new, pos, is_global, scale=scale, softcap=softcap, window=window
    )


def grouped_matmul(lhs, rhs, *, backend: BackendSpec = None) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f), the expert-FFN seam (dense rhs)."""
    if resolve_backend(backend, lhs.device) is KernelBackend.HOPPER:
        record("gmm.hopper")
        return _gmm_hopper(lhs, rhs)
    record("gmm.ref")
    return ref.grouped_matmul_ref(lhs, rhs)
