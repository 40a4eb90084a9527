"""The port's T5 (``models/t5.py``) against the JAX package's, on tiny T5
GGUFs of seeded weights (the ``enc.*`` / ``dec.*`` names; 8 relative
buckets, the bias table on layer 0 only) loaded by both loaders, in three
forms: T5's ReLU FFN with its own head, flan-T5's GELU-gated FFN, and a
tied head (scaled by d_model^-0.5):

 - the relative position bucket table as integers, exactly, for 32 and 8
   buckets, both directions, |rel| up to 512;
 - the loader's tensors by key and value (and a t5encoder file's);
 - ``t5_encode`` and the teacher-forced ``t5_decode`` logits (B 2, an
   encoder mask on one row) within 1e-5;
 - five incremental decode steps against one teacher-forced step (port)
   and against the JAX package's steps;
 - ``T5Model.generate``'s greedy tokens equal to the JAX package's;
 - a Q8_0 file loaded packed: the decode steps through ``qmv``'s plain
   version against the JAX package's packed load within NMSE 1e-5;
 - ``params_from_jax`` of the T5 tree.
Torch runs on one thread (``torch_one_thread``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models import t5 as jt5
from superllama_tpu.runtime.kv_cache import kv_cache_init as jax_cache
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models import t5 as tt5
from superllama_tpu_torch.runtime.kv_cache import kv_cache_init
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import _W, write_arch_gguf

V, E, H, D, F, L, NB = 96, 64, 4, 16, 128, 2, 8
TOL = dict(rtol=1e-5, atol=1e-5)
FORMS = ("relu", "gated", "tied")


def t5_spec(form: str, encoder_only: bool = False) -> tuple[str, dict, dict]:
    p = _W(f"t5-{form}")
    p.w("token_embd.weight", V, E, scale=1.0)
    if form != "tied":
        p.w("output.weight", V, E)
    p.norm("enc.output_norm.weight", E)
    if not encoder_only:
        p.norm("dec.output_norm.weight", E)
    for side in ("enc",) + (() if encoder_only else ("dec",)):
        for i in range(L):
            b = f"{side}.blk.{i}."
            p.norm(b + "attn_norm.weight", E)
            for n in "qkv":
                p.w(b + f"attn_{n}.weight", H * D, E)
            p.w(b + "attn_o.weight", E, H * D)
            if i == 0:
                p.w(b + "attn_rel_b.weight", NB, H, scale=1.0)
            if side == "dec":
                p.norm(b + "cross_attn_norm.weight", E)
                for n in "qkv":
                    p.w(b + f"cross_attn_{n}.weight", H * D, E)
                p.w(b + "cross_attn_o.weight", E, H * D)
            p.norm(b + "ffn_norm.weight", E)
            if form == "gated":
                p.w(b + "ffn_gate.weight", F, E)
            p.w(b + "ffn_up.weight", F, E)
            p.w(b + "ffn_down.weight", E, F)
    md = {"context_length": 512, "embedding_length": E, "block_count": L,
          "decoder_block_count": L, "feed_forward_length": F, "attention.head_count": H,
          "attention.head_count_kv": H, "attention.key_length": D,
          "attention.value_length": D, "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.relative_buckets_count": NB, "decoder_start_token_id": 0,
          "vocab_size": V}
    return ("t5encoder" if encoder_only else "t5"), md, p.t


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("t5")
    out = {}
    for form in FORMS:
        name, md, tensors = t5_spec(form)
        path = write_arch_gguf(d / f"t5_{form}.gguf", name, md, tensors)
        out[form] = (jax_load(path), load_model(path, device="cpu"))
    return out


@pytest.mark.parametrize("n_buckets", [32, 8])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidir", "causal"])
def test_bucket_table_is_exactly_jax(n_buckets, bidirectional):
    rel = np.arange(-512, 513, dtype=np.int32)[None, :] + np.zeros((2, 1), np.int32)
    got = tt5.relative_position_bucket(torch.from_numpy(rel), n_buckets, bidirectional)
    ref = jax.jit(lambda r: jt5.relative_position_bucket(r, n_buckets, bidirectional))(
        jnp.asarray(rel))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("encoder_only", [False, True], ids=["t5", "t5encoder"])
def test_loader_loads_what_jax_loads(tmp_path, encoder_only):
    name, md, tensors = t5_spec("gated", encoder_only)
    path = write_arch_gguf(tmp_path / f"{name}.gguf", name, md, tensors)
    jm, tm = jax_load(path), load_model(path, device="cpu")
    assert tm.hparams.arch == name and tm.hparams.dec_n_layer == L
    for key in ("token_embd", "output", "output_norm_enc", "output_norm"):
        assert (tm.params[key] is None) == (jm.params[key] is None), key
    for side in ("enc_layers", "dec_layers"):
        assert len(tm.params[side]) == len(jm.params[side]) == L
        for a, b in zip(jm.params[side], tm.params[side]):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)


def _src_tgt(seed: int, B: int = 2, S: int = 9, T: int = 7):
    rng = np.random.default_rng(seed)
    return rng.integers(2, V, (B, S)), rng.integers(2, V, (B, T))


@pytest.mark.parametrize("form", FORMS)
def test_encoder_matches_jax(models, form, torch_one_thread):
    jm, tm = models[form]
    src, _ = _src_tgt(0, S=11)
    ref = np.asarray(jt5.t5_encode(jm.params, jm.hparams, jnp.asarray(src, jnp.int32)))
    with torch.no_grad():
        got = tt5.t5_encode(tm.params, tm.hparams, torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _jax_decode(jm, src, tgt, steps: bool, enc_mask=None):
    hp = jm.hparams
    enc = jt5.t5_encode(jm.params, hp, jnp.asarray(src, jnp.int32))
    ckv = jt5.t5_cross_kv(jm.params, hp, enc)
    B, T = tgt.shape
    cache = jax_cache(L, B, 16, H, D, D, jnp.float32)
    em = None if enc_mask is None else jnp.asarray(enc_mask.astype(bool))
    if not steps:
        pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
        return np.asarray(jt5.t5_decode(jm.params, hp, jnp.asarray(tgt, jnp.int32), pos, cache,
                                        ckv, em)[0])
    out = []
    for i in range(T):
        lg, cache = jt5.t5_decode(jm.params, hp, jnp.asarray(tgt[:, i:i + 1], jnp.int32),
                                  jnp.full((B, 1), i, jnp.int32), cache, ckv, em)
        out.append(np.asarray(lg))
    return np.concatenate(out, axis=1)


@torch.no_grad()
def _port_decode(tm, src, tgt, steps: bool, enc_mask=None):
    hp = tm.hparams
    enc = tt5.t5_encode(tm.params, hp, torch.from_numpy(src))
    ckv = tt5.t5_cross_kv(tm.params, hp, enc)
    B, T = tgt.shape
    cache = kv_cache_init(L, B, 16, H, D, D, dtype=torch.float32)
    em = None if enc_mask is None else torch.from_numpy(enc_mask)
    if not steps:
        pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
        return tt5.t5_decode(tm.params, hp, torch.from_numpy(tgt), pos, cache, ckv, em)[0].numpy()
    out = []
    for i in range(T):
        lg, cache = tt5.t5_decode(tm.params, hp, torch.from_numpy(tgt[:, i:i + 1]),
                                  torch.full((B, 1), i, dtype=torch.int32), cache, ckv, em)
        out.append(lg.numpy())
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("form", FORMS)
def test_teacher_forced_decode_matches_jax(models, form, torch_one_thread):
    jm, tm = models[form]
    src, tgt = _src_tgt(1)
    enc_mask = np.ones(src.shape, np.int64)
    enc_mask[1, 6:] = 0
    ref = _jax_decode(jm, src, tgt, False, enc_mask)
    got = _port_decode(tm, src, tgt, False, enc_mask)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_incremental_decode_matches_oneshot_and_jax(models, form, torch_one_thread):
    jm, tm = models[form]
    src, tgt = _src_tgt(2, B=1, S=6, T=5)
    steps = _port_decode(tm, src, tgt, True)
    np.testing.assert_allclose(steps, _port_decode(tm, src, tgt, False), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(steps, _jax_decode(jm, src, tgt, True), **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_generate_tokens_equal_jax(models, form, torch_one_thread):
    jm, tm = models[form]
    src = list(np.random.default_rng(3).integers(2, V, 8))
    ref = jt5.T5Model(jm, n_ctx=32).generate(src, n_gen=12)
    got = tt5.T5Model(tm, n_ctx=32).generate(src, n_gen=12)
    assert len(got) == 12 and got == ref


def test_packed_decode_matches_jax(tmp_path, torch_one_thread):
    name, md, tensors = t5_spec("gated")
    path = write_arch_gguf(tmp_path / "t5_q8.gguf", name, md, tensors, GGMLType.Q8_0)
    jm = jax_load(path, keep_quantized=True)
    tm = load_model(path, keep_quantized=True, device="cpu")
    assert type(tm.params["dec_layers"][0]["wq"]).__name__ == "QTensor"
    src, tgt = _src_tgt(4, B=1, S=8, T=4)
    got, ref = _port_decode(tm, src, tgt, True), _jax_decode(jm, src, tgt, True)
    err = float(((got - ref) ** 2).mean() / (ref ** 2).mean())
    assert err < 1e-5, err


def test_params_from_jax_carries_t5(models, torch_one_thread):
    jm, _ = models["gated"]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), jm.hparams,
                             device="cpu")
    src, tgt = _src_tgt(5)
    tm = type("M", (), {"params": params, "hparams": jm.hparams})
    np.testing.assert_allclose(_port_decode(tm, src, tgt, False),
                               _jax_decode(jm, src, tgt, False), **TOL)
