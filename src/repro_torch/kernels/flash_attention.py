"""Wrapper of the Hopper flash-attention kernels (``csrc/flash_attention.cu``,
the C entry of both).

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel): causal (top-left aligned) or full attention with
GQA, the online softmax in fp32, fully masked KV tiles skipped.  It
keeps the JAX package's layout: q ``(B, Sq, H, D)``, k ``(B, Skv, KH,
D)``, v ``(B, Skv, KH, Dv)``, output ``(B, Sq, H, Dv)`` in q's type.
Unlike the Pallas kernel it takes any ``Sq`` and ``Skv`` (ragged tiles
are masked in the kernel), ``D`` up to 192 and ``Dv`` up to 128 (MLA's
expanded heads are 192/128), and a sliding ``window`` with the causal
mask (the JAX prefill's ``chunked_attention(window=...)``): key tiles
wholly left of every row's window are skipped like those above the
diagonal.

CUDA tensors only, fp32 or bf16, one kernel for each, both on the tensor
cores: bf16 on wgmma, K/V tiles by TMA (``csrc/flash_attention_sm90.cuh``);
fp32 in 3xTF32 on ``mma.sync`` (``csrc/flash_attention_fp32.cu``: each
operand split into two TF32 halves, three TF32 products for each fp32
one, which keeps the fp32 tolerance, 2e-5, where one TF32 pass would
not; K/V tiles by a ``cp.async`` ring).  The plain version for CPU
tensors is
``kernels.ref.flash_attention_ref``, chosen by ``kernels.ops``.  Each
launch adds one to ``flash_attention.launches``; launches are on
``torch.cuda.current_stream()`` and never synchronise.

The kernel is reached through the custom op ``repro::flash_attention``
(:func:`flash_attention_op`): the kernel on CUDA tensors, the plain
version on CPU tensors (its checks), a shape function for fake tensors
(the dry-run traces the card's path without a card) and a FLOP formula
for ``FlopCounterMode``: ``2 * B * H * pairs * (D + Dv)`` over the
visible (query, key) pairs, the count the kernel's bound uses.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import check_window, flash_attention_ref

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 192          # q and k
MAX_V_HEAD_DIM = 128        # v and the output


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0,
                    softmax_scale: Optional[float] = None) -> Tensor:
    """Attention over ``q (B, Sq, H, D)``, ``k (B, Skv, KH, D)``, ``v (B,
    Skv, KH, Dv)``; query head ``h`` reads kv head ``h // (H // KH)``.
    ``window`` > 0 (with ``causal``, ``Sq <= Skv``) lets query ``i`` see
    keys ``i - window < j <= i``.  ``softmax_scale`` defaults to ``D **
    -0.5``."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention takes CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D (B, S, heads, dim)")
    B, Sq, H, D = q.shape
    _, Skv, KH, Dv = v.shape
    if tuple(k.shape) != (B, Skv, KH, D) or v.shape[0] != B:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_V_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv} must be in "
                         f"[1, {MAX_HEAD_DIM}] and [1, {MAX_V_HEAD_DIM}]")
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    check_window(Sq, Skv, causal, window)
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    err = _build.load().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, KH, D, Dv, scale, int(bool(causal)), min(int(window), Skv),
        _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@torch.library.custom_op("repro::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int, softmax_scale: Optional[float]
                       ) -> Tensor:
    """:func:`flash_attention` (the kernel) on CUDA tensors; the plain
    version on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softmax_scale=softmax_scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softmax_scale=softmax_scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, softmax_scale):
    B, Sq, H, _ = q.shape
    return q.new_empty((B, Sq, H, v.shape[-1]))


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps, per batch and head: query ``i``
    sees keys ``j <= i`` (top-left aligned) when causal, and ``j > i -
    window`` with a window."""
    if not causal:
        return sq * skv
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1)
        lo = max(0, i - window + 1) if window else 0
        total += max(hi - lo + 1, 0)
    return total


@register_flop_formula(torch.ops.repro.flash_attention)
def flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                          *args, **kwargs) -> int:
    B, Sq, H, D = q_shape
    Skv, Dv = k_shape[1], v_shape[-1]
    return 2 * B * H * visible_pairs(Sq, Skv, causal, window) * (D + Dv)
