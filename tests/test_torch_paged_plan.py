"""The paged prefill kernels' route and geometry (superllama_tpu_torch.ops
.paged_attention.paged_plan) and the port's paged_flash_attention against
the JAX package's at prefill shapes (T*G > 32), on the CPU.

The plan is what csrc/paged.cu is launched with (the tensor-core kernel
refuses a launch whose slots a tile, row tiles or shared-memory bytes differ
from its own layout, csrc/fa_tc.cuh's make_layout), so these tests hold it
to the kernel's contract:
 - bf16 q over bf16 pages at T*G > 32 takes fa's tensor-core kernel,
   addressed through the page table, at every head size up to 256; f32 q or
   f32 pages take the CUDA-core prefill kernel; T*G <= 32 keeps the decode
   cluster kernel's plan;
 - the tensor-core plan is fa's for the row's MAXP * P logical slots plus
   the row's page table, within the H100's 232,448 bytes of shared memory
   a block, two blocks an SM at D 128;
 - the grid's row tiles cover every token at G 1-64; a cluster of two
   blocks shares a (row tile, kv head)'s tiles where two for each of one
   row's units fit one resident wave of the card's SMs, and its shares
   partition the list of visible tiles;
 - a row's logical slots, in the visible tiles the kernel lists, map to
   every occupied slot of the row's pages exactly once, at P 8, 16, 64,
   100 and 256, with gaps and absent pages. The kernel's copies of those
   slots (runs inside one page) are held to the plain version on the card
   by chip_smoke.py's cases at P 8, 16, 64 and 100 with gaps.
A CUDA tensor reaches the kernel its plan names (here its failing build),
never a plain version, and counts no launch.

Parity: the port's paged_flash_attention (its plain version on the CPU)
against the JAX kernel in interpret mode, compiled without XLA's excess
precision (xla_exact), on numpy-seeded pools. Only rows with q_pos >= 0
are compared. Tolerances: NMSE < 1e-9 in f32 (same logits, the pages sum
in another order); < 2e-5 in bf16 (p rounded to bf16 against another
running max: a rounding boundary can fall either way).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.ops.paged_attention import paged_flash_attention as jax_paged
from superllama_tpu_torch.ops.flash_attention import (FA_ROWS, SMEM_MAX, DecodePlan, FaPlan,
                                                      prefill_plan)
from superllama_tpu_torch.ops.paged_attention import paged_flash_attention, paged_plan
from test_torch_fixtures import cuda_typed, failing_build, xla_exact

HEAD_SIZES = (16, 32, 64, 80, 96, 100, 128, 192, 256)
SM_SMEM = 233472   # shared memory of one H100 SM; 1 KB a block is reserved
SMS = 132          # streaming multiprocessors of an H100 SXM


def _plan(T=128, H=32, Hkv=8, D=128, Dv=None, P=256, MAXP=8, B=8, q=torch.bfloat16,
          kv=torch.bfloat16, sms=SMS):
    qt = torch.zeros((B, T, H, D), dtype=q)
    k = torch.zeros((2, Hkv, P, D), dtype=kv)
    v = torch.zeros((2, Hkv, P, Dv or D), dtype=kv)
    return paged_plan(qt, k, v, torch.zeros((B, MAXP), dtype=torch.int32), sms=sms)


@pytest.mark.parametrize("D", HEAD_SIZES)
def test_bf16_prefill_takes_the_tensor_cores(D):
    """Every head size on the tensor cores at the serving chunk's shape (B
    8, T 128, 256-token pages, n_ctx 2048): fa's geometry for the row's
    2048 logical slots plus its 8-page table, whole 16s, 64-slot tiles up
    to 128 columns (32 above), two blocks an SM up to 128. 128 tokens of 4
    heads are 8 row tiles of 64 rows, 64 units a row with the 8 kv heads:
    a cluster of two a unit for the engine's one-row chunk, none for a call
    of 8 rows."""
    p = _plan(D=D)
    assert isinstance(p, FaPlan) and p.kernel == "tc"
    fa = prefill_plan(torch.bfloat16, torch.bfloat16, 8, 128, 32, 8, 2048, D, D)
    assert p.smem == fa.smem + 32   # + the page table, 8 entries padded to 16 bytes
    assert (p.bs, p.bt, p.dk, p.dv) == (fa.bs, fa.bt, fa.dk, fa.dv)
    assert fa.grid == (8, 8, 8) and fa.split == 1
    assert p.smem <= SMEM_MAX
    assert D <= p.dk < D + 16 and p.bs == (64 if D <= 128 else 32)
    assert p.split == 1 and p.grid == (8, 8, 8)
    one = _plan(B=1, D=D)
    assert one.split == 2 and one.grid == (16, 8, 1) and one.smem == p.smem
    if D <= 128:
        assert 2 * (p.smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("q,kv", [(torch.float32, torch.float32),
                                  (torch.float32, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)],
                         ids=["f32 q f32 pages", "f32 q bf16 pages", "bf16 q f32 pages"])
def test_f32_products_take_the_cuda_cores(D, q, kv):
    """f32 q (QK^T in f32) or f32 pages (P.V in f32): paged_kernel, its Dv
    padded to the next instantiated width, its shared memory fa's CUDA-core
    kernel's plus a tile's pool pages."""
    p = _plan(D=D, q=q, kv=kv)
    assert p.kernel == "cc" and p.dv in (64, 128, 256)
    fa = prefill_plan(q, kv, 8, 128, 32, 8, 2048, D, D)
    assert p.smem == fa.smem + 4 * FA_ROWS <= SMEM_MAX


@pytest.mark.parametrize("T,G", [(1, 4), (8, 4), (4, 8), (32, 1), (1, 32)])
def test_decode_shapes_keep_the_decode_plan(T, G):
    """T*G <= 32 stays on the decode cluster kernel, whatever the types."""
    for q in (torch.bfloat16, torch.float32):
        assert isinstance(_plan(T=T, H=2 * G, Hkv=2, q=q), DecodePlan)


@pytest.mark.parametrize("P,MAXP", [(8, 256), (16, 128), (64, 32), (100, 21), (256, 8),
                                    (16, 8192)])
def test_page_tables_fit(P, MAXP):
    """The row's table takes 4 bytes a page and the tile list 4 a tile;
    two blocks still fit an SM at n_ctx 2048 whatever the page size."""
    p = _plan(P=P, MAXP=MAXP)
    assert p.smem <= SMEM_MAX
    if P * MAXP <= 2100:
        assert 2 * (p.smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("G", [1, 3, 4, 8, 48, 64])
@pytest.mark.parametrize("T", [37, 256])
def test_row_tiles_cover_every_token(G, T):
    p = _plan(T=T, H=2 * G, Hkv=2)
    assert p.kernel == "tc" and p.bt == FA_ROWS // G
    n_rt = p.grid[0] // p.split
    assert (n_rt - 1) * p.bt < T <= n_rt * p.bt


@pytest.mark.parametrize("B,T,D,split", [(8, 32, 128, 2), (8, 128, 128, 2), (8, 256, 128, 2),
                                         (1, 256, 128, 2), (8, 256, 256, 1), (8, 128, 256, 2),
                                         (1, 2048, 128, 1), (3, 9, 64, 2), (2, 1024, 80, 1)])
def test_cluster_split_where_one_rows_units_fit_one_wave(B, T, D, split):
    """``split``: the cluster a call of one row at (T, D) takes. Clusters
    of two only where two blocks for each (row tile, kv head) of the row
    fit the card's resident blocks (264 up to 128 columns, 132 above): the
    serving chunk and a long prompt's 256-token chunk split, a 1024-token
    chunk or D 256 at T 256 does not. A call of several rows (all of them
    may be valid) never splits."""
    p = _plan(B=B, T=T, D=D)
    n_rt = -(-T // 16)
    want = split if B == 1 else 1
    assert p.split == want and p.grid == (n_rt * want, 8, B)
    assert _plan(B=1, T=T, D=D).split == split
    assert 2 * n_rt * 8 <= SMS * (2 if D <= 128 else 1) or split == 1


@pytest.mark.parametrize("sms,split", [(0, 1), (114, 1), (127, 1), (128, 2), (132, 2)])
def test_cluster_split_follows_the_sm_count(sms, split):
    """The split is sized to the card it runs on: a long prompt's
    256-token chunk (16 row tiles x 8 kv heads, two blocks a unit, two
    blocks an SM) fits one resident wave from 128 SMs on, so an H100 SXM
    (132) splits it and an H100 PCIe (114) does not; a CPU tensor's plan
    (no card) takes none. The engine sends one row a chunk."""
    p = _plan(B=1, T=256, sms=sms)
    assert p.split == split and p.grid == (16 * split, 8, 1)
    cpu = paged_plan(torch.zeros((8, 256, 32, 128), dtype=torch.bfloat16),
                     *[torch.zeros((2, 8, 256, 128), dtype=torch.bfloat16)] * 2,
                     torch.zeros((8, 8), dtype=torch.int32))
    assert cpu.split == 1


@pytest.mark.parametrize("split", [1, 2])
def test_cluster_shares_partition_the_list(split):
    """Rank r of a cluster takes tiles first .. first + n - 1 of the list
    (csrc/fa_tc.cuh): the shares are disjoint and cover it, in order."""
    for nvis in range(0, 70):
        shares = []
        for rank in range(split):
            first = nvis * rank // split
            shares += range(first, nvis * (rank + 1) // split)
        assert shares == list(range(nvis))


def _table(rng, P, MAXP, lens, gap=0, absent=()):
    """Page tables of rows holding lens[b] positions in pages of P - gap
    used slots (the gaps closed pages leave), from a shuffled pool whose
    page 0 is the NULL page; ``absent`` (row, logical page) entries -1."""
    B = len(lens)
    n_pool = B * MAXP + 1
    table = np.full((B, MAXP), -1, np.int32)
    page_pos = np.full((n_pool, P), -1, np.int32)
    order = iter(rng.permutation(np.arange(1, n_pool)))
    per = P - gap
    for b, n in enumerate(lens):
        for lg in range(-(-n // per)):
            pg = int(next(order))
            if (b, lg) in absent:
                continue
            table[b, lg] = pg
            cnt = min(per, n - lg * per)
            page_pos[pg, :cnt] = np.arange(lg * per, lg * per + cnt)
    return table, page_pos


@pytest.mark.parametrize("bs", [64, 32])
@pytest.mark.parametrize("P,MAXP,gap", [(8, 40, 0), (8, 48, 3), (16, 24, 5), (64, 8, 12),
                                        (100, 5, 7), (256, 2, 0), (256, 3, 40)])
def test_tile_copies_read_every_occupied_slot_once(bs, P, MAXP, gap):
    """The slots the kernel's visible tiles cover, mapped through the table
    as the plain version gathers them (logical slot s at page
    max(table[s // P], 0), offset s % P): every occupied slot of a row's
    pages is reached exactly once, no slot of another row's page is, and
    every occupied slot lies in a listed tile. How the kernel copies a
    tile's slots is checked on the card (chip_smoke.py), not here."""
    rng = np.random.default_rng(P * 7 + gap)
    S = P * MAXP
    lens = [S - MAXP * gap, S // 3, 1, 0]
    table, page_pos = _table(rng, P, MAXP, lens, gap, absent={(1, 1), (0, MAXP - 1)})
    for b in range(len(lens)):
        pages = np.maximum(table[b], 0)
        pos = page_pos[pages].reshape(-1)                     # the row's logical slots
        ntiles = -(-S // bs)
        listed = [i for i in range(ntiles) if (pos[i * bs:(i + 1) * bs] >= 0).any()]
        seen = np.zeros_like(page_pos)
        for tile in listed:
            for s in range(tile * bs, min((tile + 1) * bs, S)):
                if pos[s] >= 0:
                    seen[pages[s // P], s % P] += 1
        own = np.zeros(page_pos.shape[0], bool)
        own[table[b][table[b] > 0]] = True
        occupied = page_pos >= 0
        assert not occupied[0].any()                          # the NULL page holds nothing
        np.testing.assert_array_equal(seen[occupied],
                                      np.broadcast_to(own[:, None], seen.shape)[occupied])
        assert seen[~occupied].sum() == 0


def _pool(B, T, H, Hkv, D, P, MAXP, lens, seed, gap=0, absent=(), scramble=False):
    """Each row's first lens[b] positions in a shuffled pool (page 0 = NULL);
    query rows at a row's newest min(T, n) positions, then padding (-1), as
    a prompt chunk shorter than its bucket; a row of length 0 is padding
    only over an empty table. ``scramble``: each row's positions scattered
    over its pages' slots in no order, one in eight dropped (-1)."""
    rng = np.random.default_rng(seed)
    table, page_pos = _table(rng, P, MAXP, lens, gap, absent)
    n_pool = page_pos.shape[0]
    if scramble:
        for b in range(B):
            pgs = table[b][table[b] > 0]
            vals = page_pos[pgs].reshape(-1)
            vals = vals[rng.permutation(vals.size)]
            vals[rng.permutation(vals.size)[:vals.size // 8]] = -1
            page_pos[pgs] = vals.reshape(len(pgs), P)
    q_pos = np.full((B, T), -1, np.int32)
    for b, n in enumerate(lens):
        m = min(T, n)
        q_pos[b, :m] = np.arange(n - m, n)
    return {"q": rng.normal(0, 1, (B, T, H, D)).astype(np.float32),
            "k_pages": rng.normal(0, 1, (n_pool, Hkv, P, D)).astype(np.float32),
            "v_pages": rng.normal(0, 1, (n_pool, Hkv, P, D)).astype(np.float32),
            "q_pos": q_pos, "page_pos": page_pos, "page_table": table}


_NAMES = ("q", "k_pages", "v_pages", "q_pos", "page_pos", "page_table")


@pytest.mark.parametrize("kind", ["bf16", "f32", "bf16 q f32 pages"])
def test_cuda_tensor_reaches_its_kernel(monkeypatch, kind):
    """A CUDA tensor at T*G 64 goes to the kernel paged_plan names: when its
    build fails the wrapper raises that failure, runs no plain version and
    counts no launch of any paged kernel."""
    build_failed = failing_build(monkeypatch)
    inp = _pool(B=2, T=16, H=8, Hkv=2, D=32, P=16, MAXP=4, lens=[40, 9], seed=1)
    args = [torch.from_numpy(inp[n]) for n in _NAMES]
    if kind != "f32":
        args[0] = args[0].to(torch.bfloat16)
    if kind == "bf16":
        args[1], args[2] = args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)
    args = [cuda_typed(t) for t in args]
    assert paged_plan(args[0], args[1], args[2], args[5], sms=SMS).kernel == (
        "tc" if kind == "bf16" else "cc")
    before = (paged_flash_attention.launches, paged_flash_attention.launches_tc)
    with pytest.raises(build_failed):
        paged_flash_attention(*args)
    assert (paged_flash_attention.launches, paged_flash_attention.launches_tc) == before


# (name, _pool kwargs, bf16, opts): prefill shapes (T*G > 32) the CASES of
# tests/test_torch_paged.py lack, at tiny widths
CELLS = [
    ("P16 tiles across pages", dict(B=2, T=16, H=8, Hkv=2, D=32, P=16, MAXP=8,
                                    lens=[90, 50], gap=3), False, {}),
    ("P16 tiles across pages bf16", dict(B=2, T=16, H=8, Hkv=2, D=32, P=16, MAXP=8,
                                         lens=[90, 50], gap=3), True, {}),
    ("positions in no order", dict(B=2, T=16, H=8, Hkv=2, D=32, P=16, MAXP=5,
                                   lens=[70, 45], scramble=True), False, {}),
    ("positions in no order bf16 swa", dict(B=2, T=16, H=8, Hkv=2, D=32, P=16, MAXP=5,
                                            lens=[70, 45], scramble=True), True,
     {"swa_window": 24}),
    ("padding rows", dict(B=3, T=24, H=8, Hkv=2, D=32, P=8, MAXP=6, lens=[20, 0, 44],
                          absent={(2, 1)}), False, {}),
    ("padding rows bf16", dict(B=3, T=24, H=8, Hkv=2, D=32, P=8, MAXP=6, lens=[20, 0, 44]),
     True, {}),
    ("sinks softcap", dict(B=2, T=12, H=8, Hkv=2, D=32, P=16, MAXP=4, lens=[60, 33]), False,
     {"sinks": True, "logit_softcap": 30.0}),
    ("sinks softcap bf16", dict(B=2, T=12, H=8, Hkv=2, D=32, P=16, MAXP=4, lens=[60, 33]),
     True, {"sinks": True, "logit_softcap": 30.0}),
    ("D256 bf16", dict(B=1, T=9, H=8, Hkv=2, D=256, P=16, MAXP=3, lens=[40]), True, {}),
    ("G8 bf16", dict(B=2, T=8, H=16, Hkv=2, D=32, P=16, MAXP=4, lens=[50, 30]), True, {}),
]


@pytest.mark.parametrize("name,kw,bf16,opts", CELLS, ids=[c[0] for c in CELLS])
def test_paged_prefill_matches_jax(name, kw, bf16, opts):
    inp = _pool(seed=len(name), **kw)
    assert isinstance(paged_plan(*(torch.from_numpy(inp[n]) for n in
                                   ("q", "k_pages", "v_pages", "page_table"))), FaPlan)
    opts = dict(opts)
    sinks = (np.random.default_rng(9).normal(0, 1, (kw["H"],)).astype(np.float32)
             if opts.pop("sinks", False) else None)
    jargs = [jnp.asarray(inp[n]) for n in _NAMES]
    targs = [torch.from_numpy(inp[n]) for n in _NAMES]
    if bf16:
        for i in (0, 1, 2):
            jargs[i] = jargs[i].astype(jnp.bfloat16)
            targs[i] = targs[i].to(torch.bfloat16)
    ref = xla_exact(lambda *a: jax_paged(*a[:6], sinks=a[6], interpret=True, **opts),
                    *jargs, None if sinks is None else jnp.asarray(sinks))
    got = paged_flash_attention(*targs, sinks=None if sinks is None else torch.from_numpy(sinks),
                                **opts)
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and got.dtype == np.float32
    valid = inp["q_pos"] >= 0
    assert np.isfinite(got[valid]).all()
    g, r = got[valid].astype(np.float64), ref[valid].astype(np.float64)
    assert np.mean((g - r) ** 2) / np.mean(r ** 2) < (2e-5 if bf16 else 1e-9)
