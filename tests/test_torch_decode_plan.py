"""The decode kernel's geometry (superllama_tpu_torch.ops.flash_attention
.decode_plan, as fd_plan and paged_plan compute it for a call) and the
wrappers' refusals, on the CPU.

The plan is what the CUDA kernel of csrc/decode_common.cuh is launched with,
so these tests hold it to the kernel's contract at the Llama-3-8B shapes
(32/8 heads, D 128, T 1 and T 8) and at the edges the card checks:
 - every cache slot of a call belongs to exactly one block, and each block's
   slots lie inside one block_s chunk (so a Q8_0 chunk's p quantization is
   never split across clusters) and are a whole number of tiles but for the
   chunk's end;
 - fd runs one pass a chunk (the chunk's row max and pmax come from one
   exchange), paged may run several;
 - clusters hold at most 8 blocks; B 8 at S 2048 fills at least two blocks
   per SM of the H100's 132, and B 1 at S 2048 runs at least 64 blocks;
 - a tile fits one 8 KB ring stage and is a whole number of 16-byte rows.
A CUDA tensor never reaches a plain version: when the kernel build fails
the wrapper raises, on both of paged's paths (T*G ≤ 32 and above).
"""

import numpy as np
import pytest
import torch

from superllama_tpu_torch.ops import flash_attention as fa_mod
from superllama_tpu_torch.ops.flash_attention import (FD_BLOCK_S, check_bulk_copyable,
                                                      decode_plan, fd_plan)
from superllama_tpu_torch.ops.paged_attention import paged_flash_attention, paged_plan
from test_torch_fixtures import cuda_typed, failing_build

H, HKV, D = 32, 8, 128
SMS = 132
# bytes of one cache row: f32, bf16, Q8_0 codes, Q4_0 nibbles at D 128
ROW = {"f32": 4 * D, "bf16": 2 * D, "q8": D, "q4": D // 2}


def _fd_args(B, T, S, kv):
    q = torch.zeros((B, T, H, D), dtype=torch.bfloat16)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "q8": torch.int8,
          "q4": torch.uint8}[kv]
    width = D // 2 if kv == "q4" else D
    k = torch.zeros((B, HKV, S, width), dtype=dt)
    return q, k, k


def _blocks(plan, B):
    """Blocks of one call: a cluster per (chunk, row tile, kv head, batch row)."""
    return B * HKV * plan.n_s * plan.n_rt * plan.cl


def _slots(plan, S):
    """Every (chunk, rank) block's slot range of one (row tile, kv head,
    batch row), in launch order, as csrc/decode_common.cuh assigns them."""
    out = []
    for c in range(plan.n_s):
        c0, n = c * plan.bs, min(plan.bs, S - c * plan.bs)
        for rank in range(plan.cl):
            out.append((c, rank, range(c0 + min(rank * plan.nb, n),
                                       c0 + min((rank + 1) * plan.nb, n))))
    return out


@pytest.mark.parametrize("S", [1000, 2048, 4096, 32768])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("kv", ["f32", "bf16", "q8", "q4"])
def test_fd_plan_covers_every_slot_once(B, S, kv):
    plan = fd_plan(*_fd_args(B, 1, S, kv))
    seen = np.zeros(S, np.int64)
    for c, rank, rng in _slots(plan, S):
        seen[rng.start:rng.stop] += 1
        if len(rng):
            # inside one chunk: q8's per-chunk quantization stays whole
            assert c * plan.bs <= rng.start and rng.stop <= (c + 1) * plan.bs
            assert (rng.start - c * plan.bs) % plan.ts == 0
            assert len(rng) <= plan.nb
    assert (seen == 1).all()
    assert plan.npass == 1 and plan.nb <= plan.nbmax
    assert 1 <= plan.cl <= 8
    assert plan.n_s == -(-S // FD_BLOCK_S)


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8", "q4"])
def test_fd_plan_fills_the_card(kv):
    b8 = fd_plan(*_fd_args(8, 1, 2048, kv))
    assert _blocks(b8, 8) >= 2 * SMS
    b1 = fd_plan(*_fd_args(1, 1, 2048, kv))
    assert _blocks(b1, 1) >= 64
    assert b8.cl == 8 and b8.nb == 256


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8", "q4"])
def test_tile_fits_a_stage(kv):
    plan = fd_plan(*_fd_args(8, 1, 2048, kv))
    assert plan.ts * ROW[kv] <= 8192
    assert (plan.ts * ROW[kv]) % 16 == 0
    assert plan.nb % plan.ts == 0


@pytest.mark.parametrize("T", [1, 8])
def test_fd_plan_rows(T):
    plan = fd_plan(*_fd_args(8, T, 2048, "q8"))
    assert plan.R == T * (H // HKV) and plan.n_rt == 1
    assert plan.R * (plan.nb + 1) <= 8192 + plan.R


def test_fd_plan_small_chunk_uses_fewer_blocks():
    """block_s 256 in q8: the chunk holds 4 tiles, so its cluster has 4
    blocks of one tile each; eight chunks cover S 2048."""
    q, k, v = _fd_args(8, 1, 2048, "q8")
    plan = fd_plan(q, k, v, block_s=256)
    assert (plan.cl, plan.nb, plan.n_s) == (4, 64, 8)
    seen = np.zeros(2048, np.int64)
    for _, _, rng in _slots(plan, 2048):
        seen[rng.start:rng.stop] += 1
    assert (seen == 1).all()


def test_fd_refuses_a_chunk_longer_than_one_pass():
    """32 query rows hold 256 logits a slot-row, so a 4096-slot chunk over 8
    blocks (512 each) would need two passes: q8's quantization forbids it."""
    q, k, v = _fd_args(1, 8, 4096, "q8")
    assert fd_plan(q, k, v, block_s=4096).npass == 2
    args = [cuda_typed(t) for t in (q, k, v)]
    pos = cuda_typed(torch.zeros((1, 8), dtype=torch.int32))
    kv_pos = cuda_typed(torch.zeros((1, 4096), dtype=torch.int32))
    scale = cuda_typed(torch.ones((1, HKV, 4096)))
    with pytest.raises(ValueError, match="one pass"):
        fa_mod.flash_decode_attention(*args, pos, kv_pos, k_scale=scale, v_scale=scale,
                                      block_s=4096)


@pytest.mark.parametrize("P,MAXP", [(16, 128), (64, 32), (256, 8), (256, 128), (100, 9)])
@pytest.mark.parametrize("B", [1, 8])
def test_paged_plan_covers_every_slot_once(B, P, MAXP):
    q = torch.zeros((B, 1, H, D), dtype=torch.bfloat16)
    pages = torch.zeros((B * MAXP + 1, HKV, P, D), dtype=torch.bfloat16)
    table = torch.zeros((B, MAXP), dtype=torch.int32)
    plan = paged_plan(q, pages, pages, table)
    S = P * MAXP
    seen = np.zeros(S, np.int64)
    for c, rank, rng in _slots(plan, S):
        assert c == 0
        seen[rng.start:rng.stop] += 1
    assert (seen == 1).all()
    assert plan.n_s == 1 and plan.cl <= 8
    assert plan.npass == -(-plan.nb // plan.nbmax)
    if S == 2048:
        assert _blocks(plan, B) >= (2 * SMS if B == 8 else 64)


@pytest.mark.parametrize("T,G,path", [(8, 4, "decode"), (9, 4, "prefill"),
                                      (1, 4, "decode"), (32, 4, "prefill")])
def test_paged_path_by_rows(T, G, path):
    """T*G 32 takes the decode cluster kernel, 36 and more the prefill one."""
    q = torch.zeros((1, T, HKV * G, D), dtype=torch.bfloat16)
    pages = torch.zeros((9, HKV, 64, D), dtype=torch.bfloat16)
    plan = paged_plan(q, pages, pages, torch.zeros((1, 8), dtype=torch.int32))
    assert (plan is None) == (path == "prefill")


@pytest.mark.parametrize("T", [1, 9])
def test_paged_cuda_tensor_never_takes_plain_path(monkeypatch, T):
    """Both paged paths, T*G 4 (decode kernel) and 36 (prefill kernel): a
    failing build raises and no plain version runs."""
    build_failed = failing_build(monkeypatch)
    rng = np.random.default_rng(T)
    q = torch.from_numpy(rng.normal(0, 1, (1, T, 8, 32)).astype(np.float32))
    pages = torch.from_numpy(rng.normal(0, 1, (3, 2, 16, 32)).astype(np.float32))
    page_pos = torch.full((3, 16), -1, dtype=torch.int32)
    page_pos[1] = torch.arange(16)
    table = torch.tensor([[1, -1]], dtype=torch.int32)
    q_pos = torch.arange(16 - T, 16, dtype=torch.int32)[None]
    args = [cuda_typed(t) for t in (q, pages, pages, q_pos, page_pos, table)]
    before = paged_flash_attention.launches
    with pytest.raises(build_failed):
        paged_flash_attention(*args)
    assert paged_flash_attention.launches == before


@pytest.mark.parametrize("shape,dtype,ok", [((2, 4, 64, 128), torch.bfloat16, True),
                                            ((2, 4, 64, 64), torch.int8, True),
                                            ((2, 4, 64, 72), torch.int8, False),
                                            ((2, 4, 64, 6), torch.bfloat16, False)])
def test_bulk_copy_rows(shape, dtype, ok):
    """Cache rows go in by 16-byte bulk copies: a row of 72 int8 codes or 6
    bf16 values is refused with the reason, not read wrong."""
    t = torch.zeros(shape, dtype=dtype)
    if ok:
        check_bulk_copyable(t)
    else:
        with pytest.raises(ValueError, match="16 bytes"):
            check_bulk_copyable(t)
