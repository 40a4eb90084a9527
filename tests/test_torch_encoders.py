"""The port's encoders (``models/bert.py``) against the JAX package's, on
tiny GGUFs of ref_arch_specs' encoder specs (their vocabulary cut to 512
rows) loaded by both loaders:

 - every tensor the JAX loader loads, by key, for the eight architectures;
 - ``bert_forward``'s hidden states over a padded batch (a whole row, a
   row of 5 real tokens of 16, an all-padded row) for the eight
   architectures (modern-bert's and gemma-embedding's symmetric windows
   included), f32 weights, within 2e-5; the NaN entries (a fully masked
   query row's) are the JAX package's exactly;
 - packed Q8_0 weights (``keep_quantized``): a 16-row batch on ``qmv``'s
   path and a 32-row one on ``qmm``'s, against the JAX package's packed
   load, within NMSE 1e-5 (the int8-activation GEMV is discontinuous in
   its input);
 - ``pool`` in its three modes, normalized or not, ``rerank_score`` with a
   classification head, the masks and bidirectional ALiBi; the NaN-free
   pooled rows within 1e-6, an all-padded row's mean pooled to zeros in
   both;
 - nomic-bert-moe's grouped route (``_experts_apply`` with the tanh GELU,
   the ``gmm`` kernel's plain version on the CPU) against the gather form
   the CPU takes, within 1e-5;
 - ``params_from_jax`` of an encoder's tree, and the loader's refusal of a
   name no path runs.
Torch runs on one thread (``torch_one_thread``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import bert as jbert
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models.hparams import HParams as JHParams
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.models import bert as tbert
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.hparams import HParams
from superllama_tpu_torch.models.llama import _experts_apply
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import ENCODERS, write_arch_gguf, write_encoder

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("encoders")
    out = {}
    for arch in ENCODERS:
        path = write_encoder(d, arch)
        out[arch] = (jax_load(path), load_model(path, device="cpu"))
    return out


def _batch(T: int = 16, B: int = 3, seed: int = 0):
    ids = np.random.default_rng(seed).integers(0, 500, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, 5:] = 0
    mask[2:] = 0
    return ids, mask


def _both(jm, tm, ids, mask):
    ref = np.asarray(jbert.bert_forward(jm.params, jm.hparams, jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(mask, jnp.int32)))
    with torch.no_grad():
        got = tbert.bert_forward(tm.params, tm.hparams, torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    return got, ref


@pytest.mark.parametrize("arch", ENCODERS)
def test_loader_loads_what_jax_loads(models, arch):
    jm, tm = models[arch]
    have = {k for k, v in tm.params.items() if v is not None and k != "layers"}
    assert have == {k for k, v in jm.params.items() if v is not None and k != "layers"}
    assert [set(layer) for layer in tm.params["layers"]] == [
        set(layer) for layer in jm.params["layers"]]
    for il, (a, b) in enumerate(zip(jm.params["layers"], tm.params["layers"])):
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=f"{il} {k}")


@pytest.mark.parametrize("arch", ENCODERS)
def test_hidden_states_match_jax(models, arch, torch_one_thread):
    ids, mask = _batch()
    got, ref = _both(*models[arch], ids, mask)
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref[2]).all()             # the all-padded row: every key masked


@pytest.mark.parametrize("rows", [16, 32], ids=["qmv-16", "qmm-32"])
def test_packed_weights_match_jax(tmp_path, rows, torch_one_thread):
    """nomic-bert packed as Q8_0 (its fused qkv read dense, as both loaders
    read it): B 1 × T rows."""
    path = write_encoder(tmp_path, "nomic-bert", GGMLType.Q8_0)
    jm = jax_load(path, keep_quantized=True)
    tm = load_model(path, keep_quantized=True, device="cpu")
    assert type(tm.params["layers"][0]["ffn_up"]).__name__ == "QTensor"
    ids = np.random.default_rng(rows).integers(0, 500, (1, rows))
    got, ref = _both(jm, tm, ids, np.ones((1, rows), np.int64))
    err = float(((got - ref) ** 2).mean() / (ref ** 2).mean())
    assert err < 1e-5, err


@pytest.mark.parametrize("pooling", ["mean", "cls", "last"])
@pytest.mark.parametrize("normalize", [True, False], ids=["normed", "raw"])
def test_pool_matches_jax(models, pooling, normalize):
    ids, mask = _batch()
    got, ref = _both(*models["modern-bert"], ids, mask)
    mask[2, 0] = 1                            # "last" needs a token a row
    g = tbert.pool(torch.from_numpy(got), torch.from_numpy(mask), pooling, normalize).numpy()
    r = np.asarray(jbert.pool(jnp.asarray(ref), jnp.asarray(mask, jnp.int32), pooling,
                              normalize))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    ok = ~np.isnan(r)
    np.testing.assert_allclose(g[ok], r[ok], rtol=1e-6, atol=1e-6)


def test_mean_pool_of_an_all_padded_row_is_zero(models):
    ids, mask = _batch()
    got, ref = _both(*models["gemma-embedding"], ids, mask)
    g = tbert.pool(torch.from_numpy(got), torch.from_numpy(mask)).numpy()
    r = np.asarray(jbert.pool(jnp.asarray(ref), jnp.asarray(mask, jnp.int32)))
    assert not np.isnan(g).any() and not np.isnan(r).any()
    assert (g[2] == 0).all() and (r[2] == 0).all()
    np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["bert", "jina-bert-v3"])
def test_rerank_score_matches_jax(tmp_path, arch, torch_one_thread):
    path = write_encoder(tmp_path, arch, cls=True)
    jm, tm = jax_load(path), load_model(path, device="cpu")
    assert tm.params["cls_out"].shape == (jm.hparams.n_embd, 1)
    ids, mask = _batch(T=12)
    mask[2, :4] = 1
    got, ref = _both(jm, tm, ids, mask)
    g = tbert.rerank_score(tm.params, torch.from_numpy(got), torch.from_numpy(mask)).numpy()
    r = np.asarray(jbert.rerank_score(jm.params, jnp.asarray(ref), jnp.asarray(mask)))
    assert g.shape == (3,)
    np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("arch,T", [("modern-bert", 12), ("gemma-embedding", 20),
                                    ("jina-bert-v2", 9), ("bert", 7)])
def test_masks_match_jax(models, arch, T):
    jm, tm = models[arch]
    mask = np.ones((2, T), np.int64)
    mask[1, T // 2:] = 0
    gf, gs = tbert._enc_masks(tm.hparams, torch.from_numpy(mask))
    rf, rs = jbert._enc_masks(jm.hparams, jnp.asarray(mask, jnp.int32))
    for g, r in ((gf, rf), (gs, rs)):
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(r), g.shape))


@pytest.mark.parametrize("H", [4, 6, 12])
def test_alibi_bias_matches_jax(H):
    kw = dict(arch="jina-bert-v2", n_vocab=8, n_ctx_train=8, n_embd=8 * H, n_layer=1,
              n_head=H, n_head_kv=H, n_ff=8, n_rot=0, head_dim=8, head_dim_v=8)
    got = tbert._alibi_bias(HParams(**kw), 10, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jbert._alibi_bias(JHParams(**kw), 10)))


@pytest.mark.parametrize("B,T,seed", [(2, 5, 0), (1, 16, 1), (3, 7, 2)])
def test_grouped_moe_route_matches_gather(models, B, T, seed):
    """The CUDA route of nomic-bert-moe's experts (rows sorted by expert,
    grouped matmuls) against the gather form, on layer 1's real experts."""
    _, tm = models["nomic-bert-moe"]
    hp, layer = tm.hparams, tm.params["layers"][1]
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, T, hp.n_embd)).astype(np.float32))
    probs = torch.softmax(x @ layer["ffn_gate_inp"], dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :hp.n_expert_used], top_i[..., :hp.n_expert_used]
    got = _experts_apply(x, top_w, top_i, layer, hp, activation="gelu_tanh")
    ref = tbert._enc_moe_gather(layer, x, top_w, top_i)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbert._enc_moe(layer, hp, x).numpy(), ref.numpy(), rtol=0, atol=0)


def test_params_from_jax_carries_an_encoder(models, torch_one_thread):
    import jax

    jm, _ = models["nomic-bert-moe"]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), jm.hparams,
                             device="cpu")
    ids, mask = _batch(T=8)
    ref = np.asarray(jbert.bert_forward(jm.params, jm.hparams, jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(mask, jnp.int32)))
    with torch.no_grad():
        got = tbert.bert_forward(params, jm.hparams, torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], ref[live], **TOL)


def test_loader_refuses_a_name_no_path_runs(tmp_path):
    from test_torch_fixtures import dense_spec

    _, md, tensors = dense_spec("llama")
    path = write_arch_gguf(tmp_path / "nope.gguf", "no-such-arch", md, tensors)
    with pytest.raises(NotImplementedError, match="no-such-arch.*no forward of the registry"):
        load_model(path, device="cpu")
