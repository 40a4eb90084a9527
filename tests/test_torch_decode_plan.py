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
 - fd at the forward's block_s runs one pass a chunk; a longer chunk runs
   several passes whose logits wait in a workspace of R x nb floats a
   block, so the chunk's row max and pmax still come from one exchange;
   paged may run several passes;
 - clusters hold at most 8 blocks; B 8 at S 2048 fills at least two blocks
   per SM of the H100's 132, and B 1 at S 2048 runs at least 64 blocks;
 - a tile fits one 8 KB ring stage of rows at 16-byte strides; rows that
   are not 16-byte multiples take the word or byte copy path.
A CUDA tensor never reaches a plain version: when the kernel build fails
the wrapper raises, on both of paged's paths (T*G ≤ 32 and above). Every
head size up to 256 reaches the kernels (the wrappers refuse only what no
path serves: D or Dv above 256, Q4_0 rows that are not whole 32-groups).
"""

import numpy as np
import pytest
import torch

from superllama_tpu_torch.ops import flash_attention as fa_mod
from superllama_tpu_torch.ops.flash_attention import (COPY_BULK, COPY_BYTES, COPY_WORDS,
                                                      FD_BLOCK_S, DecodePlan, copy_mode,
                                                      decode_plan, fd_plan, flash_attention)
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
    assert plan.ts % 16 == 0 or plan.ts < 16


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


@pytest.mark.parametrize("kv", ["f32", "bf16", "q8", "q4"])
def test_fd_two_pass_chunk_covers_every_slot_once(monkeypatch, kv):
    """32 query rows hold 256 logits a slot-row, so a 4096-slot chunk over 8
    blocks (512 each in q8) takes two passes: every slot still belongs to one
    block and one pass, the passes' logits fit the block's workspace rows,
    and the wrapper takes the call to the kernel (here its failing build)
    instead of refusing it."""
    q, k, v = _fd_args(1, 8, 4096, kv)
    plan = fd_plan(q, k, v, block_s=4096)
    assert plan.npass >= 2 and plan.R == 32
    seen = np.zeros(4096, np.int64)
    for _, _, rng in _slots(plan, 4096):
        assert len(rng) <= plan.nb   # a block's logits fit its R x nb workspace
        for p in range(plan.npass):
            lo = rng.start + p * plan.nbmax
            seen[lo:min(lo + plan.nbmax, rng.stop)] += 1
    assert (seen == 1).all()
    build_failed = failing_build(monkeypatch)
    args = [cuda_typed(t) for t in (q, k, v)]
    pos = cuda_typed(torch.zeros((1, 8), dtype=torch.int32))
    kv_pos = cuda_typed(torch.zeros((1, 4096), dtype=torch.int32))
    extra = {}
    if kv in ("q8", "q4"):
        shape = (1, HKV, 4096) + ((D // 32,) if kv == "q4" else ())
        scale = cuda_typed(torch.ones(shape))
        extra = {"k_scale": scale, "v_scale": scale}
    with pytest.raises(build_failed):
        fa_mod.flash_decode_attention(*args, pos, kv_pos, block_s=4096, **extra)


def test_fd_forward_block_s_is_one_pass():
    """The forward's block_s 2048 stays one pass at every T*G the decode
    kernel takes, so its launches and readings do not change."""
    for T in (1, 2, 4, 8):
        for kv in ("f32", "bf16", "q8", "q4"):
            assert fd_plan(*_fd_args(8, T, 2048, kv)).npass == 1


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
    assert isinstance(plan, DecodePlan) == (path == "decode")


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


@pytest.mark.parametrize("shape,dtype,mode", [((2, 4, 64, 128), torch.bfloat16, COPY_BULK),
                                              ((2, 4, 64, 64), torch.int8, COPY_BULK),
                                              ((2, 4, 64, 72), torch.int8, COPY_WORDS),
                                              ((2, 4, 64, 6), torch.bfloat16, COPY_WORDS),
                                              ((2, 4, 64, 100), torch.int8, COPY_WORDS),
                                              ((2, 4, 64, 100), torch.bfloat16, COPY_WORDS),
                                              ((2, 4, 64, 50), torch.int8, COPY_BYTES)])
def test_bulk_copy_rows(shape, dtype, mode):
    """Cache rows go in by 16-byte bulk copies where rows, strides and bases
    allow; a row of 72 or 100 int8 codes, or 6 or 100 bf16 values, takes
    4-byte copies, and 50 codes byte copies, instead of being refused."""
    assert copy_mode(torch.zeros(shape, dtype=dtype)) == mode


def test_copy_mode_follows_the_base_address():
    """A view that starts 8 bytes into its storage is not bulk-copyable even
    when its rows are."""
    t = torch.zeros(2 * 4 * 64 * 128 + 4, dtype=torch.bfloat16)[4:].view(2, 4, 64, 128)
    assert t.data_ptr() % 16 == 8 and copy_mode(t) == COPY_WORDS


def test_plan_of_unaligned_rows_fits_a_stage():
    """100-byte Q8_0 rows sit at 112-byte strides in the ring: 73 would fit
    a stage, a tile takes 64 (whole 16-slot groups); 160-byte bf16 rows (D
    80) 48."""
    assert decode_plan(2048, 2048, 4, 100, 100).ts == 64
    assert decode_plan(2048, 2048, 4, 160, 160).ts == 48


def _cuda_call(kernel, Dv, T=1):
    """A call of one wrapper with CUDA-typed tensors at head size D = Dv."""
    G, Hkv, S, P = 4, 2, 64, 16
    q = torch.zeros((1, T, G * Hkv, Dv), dtype=torch.bfloat16)
    pos = torch.zeros((1, T), dtype=torch.int32)
    if kernel in ("paged decode", "paged prefill"):
        pages = torch.zeros((5, Hkv, P, Dv), dtype=torch.bfloat16)
        args = (q, pages, pages, pos, torch.zeros((5, P), dtype=torch.int32),
                torch.zeros((1, 4), dtype=torch.int32))
        return paged_flash_attention, [cuda_typed(t) for t in args], {}
    kv_pos = torch.zeros((1, S), dtype=torch.int32)
    if kernel == "fa":
        kv = torch.zeros((1, Hkv, S, Dv), dtype=torch.bfloat16)
        return flash_attention, [cuda_typed(t) for t in (q, kv, kv, pos, kv_pos)], {}
    mode = kernel.split()[1]
    width, dt = {"f": (Dv, torch.bfloat16), "q8": (Dv, torch.int8),
                 "q4": (Dv // 2, torch.uint8)}[mode]
    kv = torch.zeros((1, Hkv, S, width), dtype=dt)
    extra = {}
    if mode != "f":
        scale = torch.ones((1, Hkv, S) + ((Dv // 32,) if mode == "q4" else ()))
        extra = {"k_scale": cuda_typed(scale), "v_scale": cuda_typed(scale)}
    return (fa_mod.flash_decode_attention,
            [cuda_typed(t) for t in (q, kv, kv, pos, kv_pos)], extra)


@pytest.mark.parametrize("kernel,Dv", [
    (k, Dv) for k in ("fa", "paged decode", "paged prefill", "fd f", "fd q8", "fd q4")
    for Dv in (80, 96, 100, 256) if k != "fd q4" or Dv % 32 == 0])
def test_every_head_size_reaches_the_kernel(monkeypatch, kernel, Dv):
    """Head sizes outside 16/32/64/128 and rows that are not 16-byte
    multiples go to the kernels (here their failing build), on every path;
    q4 at whole 32-groups (96, 256), as a Q4_0 cache holds them."""
    build_failed = failing_build(monkeypatch)
    fn, args, extra = _cuda_call(kernel, Dv, T=9 if kernel == "paged prefill" else 1)
    with pytest.raises(build_failed):
        fn(*args, **extra)


@pytest.mark.parametrize("kernel", ["fa", "paged decode", "fd f", "fd q8"])
def test_head_size_above_256_is_refused(kernel):
    fn, args, extra = _cuda_call(kernel, 288)
    with pytest.raises(ValueError, match="unsupported"):
        fn(*args, **extra)
