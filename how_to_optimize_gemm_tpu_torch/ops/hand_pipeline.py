"""Rung 17: rung 14's arithmetic under a hand-scheduled stream pipeline.

Counterpart of ``how_to_optimize_gemm_tpu/ops/pallas_emit_pipeline.py``.
``mmult_q_bt_hand`` computes rung 14's ``C = f32(QA @ QBT^T as int32) *
sa[i] * sb[j] + C`` IN PLACE on ``c`` (the reference aliases C into its
output), B packed transposed (N, K), and keeps the reference's two schedule
knobs: ``b_buffers``, the depth of the (A, B^T) chunk ring, and
``a_lookahead``, whether the copies may run into the next tile before the
MMA warps have finished this one. The kernel (``csrc/int8_hand_pipe.cu``,
``int8_hand_pipe_nt``) is warp-specialised: one producer warp issues
every copy into the ring (``cp.async``, mbarriers per slot), eight MMA
warps run rung 14's tile, persistent over its 128 x 128 tiles. The
reference's ``bm``, ``bn`` and ``vmem_limit_mb`` size VMEM blocks and have
no counterpart here (``ops/tuned.py`` leaves the VMEM choosers out the same
way).

For CUDA tensors the wrapper launches its kernel; for CPU tensors it runs
rung 14's plain version (``int8.mmult_q_bt_ref``). The kernel equals it,
and ``int8_gemm_nt``, bit for bit.
"""
from __future__ import annotations

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import int8

# the ring depths built (the reference test's grid, tests/test_emit_pipeline)
B_BUFFERS = (2, 3, 4)


def mmult_q_bt_hand(qa, sa, qbt, sb, c, *, b_buffers: int = 3,
                    a_lookahead: bool = True):
    """C = dequant(QA @ QBT^T) + C in place on ``c``, which is returned.

    qa (M, K) int8, sa (M, 1), qbt (N, K) int8, sb (1, N), c (M, N)
    float32. ``b_buffers`` in ``B_BUFFERS`` and a bool ``a_lookahead``,
    else ValueError."""
    if not (isinstance(b_buffers, int) and not isinstance(b_buffers, bool)
            and b_buffers in B_BUFFERS) or not isinstance(a_lookahead, bool):
        raise ValueError(f"mmult_q_bt_hand: b_buffers {b_buffers!r} not in "
                         f"{B_BUFFERS} or a_lookahead {a_lookahead!r} not a "
                         "bool")
    if c.device.type == "cpu":
        c.copy_(int8.mmult_q_bt_ref(qa, sa, qbt, sb, c))
        return c
    int8.require_cuda("mmult_q_bt_hand", c)
    m, n = c.shape
    qa, qbt = int8.bt_operands("mmult_q_bt_hand", qa, sa, qbt, sb, c)
    if m and n:
        kp = qa.shape[1]
        _build.launch("int8_hand_pipe_nt", c.device, qa, qbt, sa, sb, c, c,
                      m, n, kp, kp, kp, n, b_buffers, int(a_lookahead))
    return c
