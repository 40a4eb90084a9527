"""The port's tree-mask forward, LookaheadDecoder and SelfExtend against the
JAX package's, on the CPU (the tiny F32 llama GGUF of the fixtures):

 - ``llama_forward`` with an additive ``attn_mask`` (a tree mask over the
   prefix and the step's own cells) against the JAX forward: logits within
   1e-4 and the cache rows written; a paged cache with a mask raises;
 - ``LookaheadDecoder``: tokens, accepted count and steps equal the JAX
   decoder's, and its tokens equal the port's plain greedy ``Context``;
 - ``SelfExtend``: tokens, the herded cache positions (the passkey
   formula's) and the re-roped K (1e-5) equal the JAX package's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu_torch.models import load_model
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import prompt, write_tiny_llama

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("la"))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


def tree_mask(n_past: int, T: int, S: int, seed: int) -> np.ndarray:
    """(1, 1, T, S) additive mask: the prefix visible, each cell of the step
    sees itself and a random subset of the earlier cells of the step."""
    rng = np.random.default_rng(seed)
    m = np.full((1, 1, T, S), -1e30, np.float32)
    m[0, 0, :, :n_past] = 0.0
    for t in range(T):
        m[0, 0, t, n_past + t] = 0.0
        for s in range(t):
            if rng.random() < 0.5:
                m[0, 0, t, n_past + s] = 0.0
    return m


def test_forward_with_attn_mask_matches_jax(model, jax_model):
    from superllama_tpu.models.llama import llama_forward as jfwd
    from superllama_tpu.runtime.kv_cache import kv_cache_init as jinit
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init

    hp, S = model.hparams, 64
    tc = kv_cache_init(hp.n_layer, 1, S, hp.n_head_kv, hp.head_dim, dtype=torch.float32)
    jc = jinit(hp.n_layer, 1, S, hp.n_head_kv, hp.head_dim, dtype=jnp.float32)
    p = np.asarray([prompt(20, 1)], np.int64)
    pos = np.arange(20, dtype=np.int32)[None]
    llama_forward(model.params, hp, torch.from_numpy(p), torch.from_numpy(pos), tc)
    _, jc = jfwd(jax_model.params, jax_model.hparams, jnp.asarray(p, jnp.int32),
                 jnp.asarray(pos), jc)
    T = 9
    toks = np.asarray([prompt(T + 1, 2)[1:]], np.int64)
    # the step's cells at positions 20 + depth in a tree of branches
    tpos = (20 + np.asarray([0, 1, 1, 2, 2, 3, 1, 2, 3], np.int32))[None]
    mask = tree_mask(20, T, S, 3)
    tl, _ = llama_forward(model.params, hp, torch.from_numpy(toks), torch.from_numpy(tpos),
                          tc, attn_mask=torch.from_numpy(mask))
    jl, jc = jfwd(jax_model.params, jax_model.hparams, jnp.asarray(toks, jnp.int32),
                  jnp.asarray(tpos), jc, attn_mask=jnp.asarray(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tc.pos[:, :S].numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(tc.k[:, :, :, :S].numpy(), np.asarray(jc.k), rtol=1e-5,
                               atol=1e-5)
    # the mask really replaces the causal one: a different mask, other logits
    tc.pos[0, 20:].fill_(-1)
    tc.cursor.fill_(20)
    other, _ = llama_forward(model.params, hp, torch.from_numpy(toks), torch.from_numpy(tpos),
                             tc, attn_mask=torch.from_numpy(tree_mask(20, T, S, 4)))
    assert not torch.allclose(other, tl)


def test_attn_mask_refused_on_paged(model):
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.paged_kv import paged_cache_init

    hp = model.hparams
    pc = paged_cache_init(hp.n_layer, 4, 16, 1, 2, hp.n_head_kv, hp.head_dim,
                          dtype=torch.float32)
    with pytest.raises(ValueError, match="dense"):
        llama_forward(model.params, hp, torch.zeros((1, 2), dtype=torch.int64),
                      torch.zeros((1, 2), dtype=torch.int32), pc,
                      attn_mask=torch.zeros((1, 1, 2, 32)))


@pytest.mark.parametrize("cfg", [(4, 3, 4, 40, 4), (3, 4, 2, 24, 7)],
                         ids=["W4-N3-G4", "W3-N4-G2"])
def test_lookahead_matches_jax(model, jax_model, cfg):
    from superllama_tpu.runtime.lookahead import LookaheadDecoder as JaxLookahead
    from superllama_tpu_torch.runtime.context import Context
    from superllama_tpu_torch.runtime.lookahead import LookaheadDecoder

    W, N, G, n, seed = cfg
    p = prompt(12, seed)
    t = LookaheadDecoder(model, W=W, N=N, G=G, n_ctx=256, device="cpu")
    j = JaxLookahead(jax_model, W=W, N=N, G=G, n_ctx=256)
    got = t.generate(p, n)
    assert got == j.generate(p, n)
    assert (t.n_accept, t.n_steps) == (j.n_accept, j.n_steps)
    assert t.n_accept > 0 and t.n_steps < n
    ctx = Context(model, n_ctx=256, kv_dtype=torch.float32, device="cpu")
    assert got == ctx.greedy_generate(p, n, stop_eog=False)


def test_self_extend_matches_jax(model, jax_model):
    from superllama_tpu.runtime.context import Context as JaxContext
    from superllama_tpu.runtime.self_extend import SelfExtend as JaxSelfExtend
    from superllama_tpu_torch.runtime.context import Context
    from superllama_tpu_torch.runtime.self_extend import SelfExtend

    n_ctx, ga_n, ga_w = 128, 4, 16
    tctx = Context(model, n_ctx=n_ctx, kv_dtype=torch.float32, device="cpu")
    jctx = JaxContext(jax_model, n_ctx=n_ctx, kv_dtype=jnp.float32)
    t, j = SelfExtend(tctx, ga_n=ga_n, ga_w=ga_w), JaxSelfExtend(jctx, ga_n=ga_n, ga_w=ga_w)
    p = prompt(80, 2)
    got = t.generate(p, 8, chunk=16)
    assert got == j.generate(p, 8, chunk=16)
    assert (t.n_past, t.ga_i) == (j.n_past, j.ga_i)
    n = int(tctx.cache.cursor[0])
    assert n == int(jctx.cache.cursor[0]) == 87
    pos = tctx.cache.pos[0, :n].numpy()
    np.testing.assert_array_equal(pos, np.asarray(jctx.cache.pos[0, :n]))
    np.testing.assert_array_equal(pos, herded(len(p), 7, ga_n, ga_w))
    np.testing.assert_allclose(tctx.cache.k[:, 0, :, :n].numpy(),
                               np.asarray(jctx.cache.k[:, 0, :, :n]), rtol=1e-5, atol=1e-5)


def herded(n_prompt: int, n_dec: int, ga_n: int, ga_w: int, chunk: int = 16) -> np.ndarray:
    """The cache positions of a prompt fed in chunks, then n_dec tokens one
    by one, under passkey.cpp's herding: each compression (before a feed,
    while n_past ≥ ga_i + ga_w) moves the positions as seq_add / seq_div /
    seq_add do."""
    pos: list[int] = []
    n_past = ga_i = 0

    def feed(k):
        nonlocal n_past
        while n_past >= ga_i + ga_w:
            herd()
        pos.extend(range(n_past, n_past + k))
        n_past += k

    def herd():
        nonlocal n_past, ga_i
        ib = (ga_n * ga_i) // ga_w
        bd = (ga_w // ga_n) * (ga_n - 1)
        dd = (ga_w // ga_n) - ib * bd - ga_w
        for i, p in enumerate(pos):
            if ga_i <= p < n_past:
                p += ib * bd
            if ga_i + ib * bd <= p < ga_i + ib * bd + ga_w:
                p //= ga_n
            elif ga_i + ib * bd + ga_w <= p < n_past + ib * bd:
                p += dd
            pos[i] = p
        n_past -= bd
        ga_i += ga_w // ga_n

    for i in range(0, n_prompt, chunk):
        feed(min(chunk, n_prompt - i))
    for _ in range(n_dec):
        feed(1)
    return np.asarray(pos)
