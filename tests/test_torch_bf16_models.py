"""Port parity for the zoo's ``--bf16`` policy: DLRM, DCN, WDL, DeepFM and
DSSM built with ``compute_dtype=bfloat16`` give the flax modules' logits
(flax weights carried across by load_flax_params). Parameters stay f32;
each Dense casts input, kernel and bias to bf16, rounds its product and
its bias add there, and the towers hand f32 back."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeprec_tpu.models import ctr as jctr

from deeprec_tpu_torch.models import ctr as tctr

torch.set_num_threads(1)

NAMES = ["C1", "C2", "C3"]
WIDE = ["W1", "W2", "W3"]
DIM, DENSE, B = 4, 3, 32
# both sides round the same values at the same points, so the logits
# agree to f32 sums in another order (measured: at most 1e-6 of the
# largest logit); a product summed in f32 in another order may still
# round one bf16 step apart on another CPU, so allow one bf16 step (2^-8)
# of the largest logit
BF16_TOL = 2.0 ** -8
# and the bf16 policy does move the logits off the f32 model's
MIN_F32_GAP = 1e-4


def _models(kind, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if kind == "dlrm":
        return (jctr.DLRM(emb_names=NAMES, emb_dim=DIM, bottom_units=(16, 8),
                          top_units=(16, 8), compute_dtype=jd),
                tctr.DLRM(NAMES, DIM, bottom_units=(16, 8),
                          top_units=(16, 8), dense_dim=DENSE,
                          compute_dtype=dtype))
    if kind == "dcn":
        return (jctr.DCN(emb_names=NAMES, cross_layers=3, deep_units=(16, 8),
                         compute_dtype=jd),
                tctr.DCN(NAMES, DIM, cross_layers=3, deep_units=(16, 8),
                         dense_dim=DENSE, compute_dtype=dtype))
    if kind == "wdl":
        return (jctr.WDL(emb_names=NAMES, wide_names=WIDE,
                         deep_units=(16, 8), compute_dtype=jd),
                tctr.WDL(NAMES, WIDE, DIM, deep_units=(16, 8),
                         dense_dim=DENSE, compute_dtype=dtype))
    if kind == "deepfm":
        return (jctr.DeepFM(emb_names=NAMES, wide_names=WIDE,
                            deep_units=(16, 16), compute_dtype=jd),
                tctr.DeepFM(NAMES, WIDE, DIM, deep_units=(16, 16),
                            dense_dim=DENSE, compute_dtype=dtype))
    return (jctr.DSSM(user_emb_names=["C1", "C3"], item_emb_names=["C2"],
                      tower_units=(16, 8), out_dim=6, compute_dtype=jd),
            tctr.DSSM(["C1", "C3"], ["C2"], DIM, tower_units=(16, 8),
                      out_dim=6, compute_dtype=dtype))


def _inputs(kind, t, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    emb = {n: rng.normal(size=(B, DIM)).astype(np.float32) for n in NAMES}
    wide = {n: rng.normal(size=(B, 1)).astype(np.float32) for n in WIDE}
    conv = torch.from_numpy if t else jnp.asarray
    kw = {"train": False}
    if kind in ("wdl", "deepfm"):
        kw["wide"] = {k: conv(v) for k, v in wide.items()}
    d = None if kind == "dssm" else conv(dense)
    return (d, {k: conv(v) for k, v in emb.items()}), kw


@pytest.mark.parametrize("kind", ["dlrm", "dcn", "wdl", "deepfm", "dssm"])
def test_bf16_forward_matches_flax(kind):
    jm, tm = _models(kind, torch.bfloat16)
    ja, jkw = _inputs(kind, False)
    ta, tkw = _inputs(kind, True)
    params = jm.init(jax.random.key(1), *ja, **jkw)
    leaves = jax.tree_util.tree_leaves(params)
    # the parameters stay f32 under the policy, on both sides
    assert all(np.asarray(x).dtype == np.float32 for x in leaves)
    tctr.load_flax_params(tm, [np.asarray(x) for x in leaves])
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ref = np.asarray(jm.apply(params, *ja, **jkw))
    with torch.no_grad():
        got = tm(*ta, **tkw)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=BF16_TOL * np.abs(ref).max())
    # the same weights at f32 give other logits: the policy is in force
    _, t32 = _models(kind, torch.float32)
    tctr.load_flax_params(t32, [np.asarray(x) for x in leaves])
    with torch.no_grad():
        f32 = t32(*ta, **tkw)
    assert (f32 - got).abs().max().item() > MIN_F32_GAP
