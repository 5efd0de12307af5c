"""BST (``models/sequence.py`` ``BST``, ``models/layers.py``
``MultiHeadSelfAttention`` and ``TransformerBlock``, the zoo entry
``modelzoo/BST/train.py``) on the CPU, held to the benchmark's plain
reference (``perfbench/reference/bst.py``) on seeded random weights at
emb 4, history 6, 2 heads, batch 8, with histories of length 1, of the
middle and full:

- logits, loss and every parameter's and input's gradient, at float64
  and at float32;
- the padded slots' embeddings change neither the logits nor a gradient;
- dropout is the identity in eval and, in training, keeps each value
  scaled by ``1 / (1 - p)`` or zeroes it;
- the recency rank of each slot, with holes in a history too;
- a save and restore through ``CheckpointManager`` round-trips the dense
  leaves and Adam's state, and the next step agrees;
- the zoo entry trains and evaluates through ``cli.run`` on both engines.
The JAX package has no BST, so there is nothing to hold it to there."""
import importlib

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
from deeprec_tpu_torch.data.behavior import SyntheticBehavior
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.models.layers import TransformerBlock
from deeprec_tpu_torch.models.sequence import BST
from deeprec_tpu_torch.train import cli
from perfbench.reference import bst as ref

torch.set_num_threads(1)

B, L, E, HEADS, D_FF = 8, 6, 4, 2, 48
LENGTHS = [1, 3, 6, 2, 6, 1, 4, 5]
CFG = {"emb_dim": E, "heads": HEADS, "d_ff": D_FF, "hidden_units": [16, 8],
       "candidate": ["item", "cate"], "history": ["hist_item", "hist_cate"],
       "context": ["uid"], "flags": ["--max_len", str(L), "--dropout", "0"]}
# float64: the same sums in another order (LayerNorm's statistics, the
# softmax's, the heads' products), so agreement to 1e-10 of each tensor's
# largest value; a wrong mask, rank or slot is off by O(1)
F64_TOL = 1e-10
# float32: the same, at float32's 6e-8 unit round-off, grown through the
# block's two LayerNorms and the three-layer tower's backward: 2e-5 of
# each tensor's largest value
F32_TOL = 2e-5


def _model(dropout=0.0, dtype=torch.float64):
    return BST(candidate_name="item", seq_name="hist_item", emb_dim=E,
               max_len=L, candidate_context_names=["cate"],
               seq_context_names=["hist_cate"], context_names=["uid"],
               heads=HEADS, hidden_units=(16, 8),
               dropout=dropout).to(dtype)


def _weights(seed, dtype):
    """The reference's parameters, drawn: LeCun normals, and the norms'
    scales and every bias moved off their init so each is exercised."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in ref.params(CFG):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        if init == "lecun":
            x = x * np.prod(shape[1:]) ** -0.5
        else:
            x = (1.0 if init == "ones" else 0.0) + 0.1 * x
        out[name] = x.to(dtype)
    return out


def _inputs(seed, dtype):
    g = torch.Generator().manual_seed(seed + 1)
    mask = torch.arange(L)[None, :] < torch.tensor(LENGTHS)[:, None]
    seq = {c: torch.randn((B, L, E), generator=g, dtype=dtype)
           * mask[..., None] for c in CFG["history"]}
    emb = torch.randn((B, 3, E), generator=g, dtype=dtype)
    y = (torch.rand((B,), generator=g) < 0.5).to(dtype)
    return emb, seq, mask, y


def _loss(z, y):
    return torch.nn.functional.binary_cross_entropy_with_logits(z, y)


def _port(w, emb, seq, mask, y, dtype, train=True, model=None):
    """Logits, loss and the gradients of every parameter and input."""
    m = model or _model(dtype=dtype)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(w[n])
    emb = emb.clone().requires_grad_(True)
    seq = {c: s.clone().requires_grad_(True) for c, s in seq.items()}
    one = {n: emb[:, i] for i, n in enumerate(["item", "cate", "uid"])}
    z = m(None, one, {c: (s, mask) for c, s in seq.items()}, train=train)
    loss = _loss(z, y)
    names = [n for n, _ in m.named_parameters()]
    gs = torch.autograd.grad(loss, list(m.parameters()) + [emb]
                             + list(seq.values()))
    return z.detach(), loss.detach(), dict(zip(
        names + ["emb"] + list(seq), gs))


def _reference(w, emb, seq, mask, y):
    w = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    emb = emb.clone().requires_grad_(True)
    seq = {c: s.clone().requires_grad_(True) for c, s in seq.items()}
    inputs = {"names": ["item", "cate", "uid"], "emb": emb, "dense": None,
              "seq": {c: (s, mask) for c, s in seq.items()}}
    z, aux = ref.forward(CFG, w, inputs, True)
    assert aux is None
    loss = _loss(z, y)
    gs = torch.autograd.grad(loss, list(w.values()) + [emb]
                             + list(seq.values()))
    return z.detach(), loss.detach(), dict(zip(
        list(w) + ["emb"] + list(seq), gs))


def _close(a, b, tol):
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= tol * scale, \
        (float((a - b).abs().max()), scale)


def test_the_port_has_the_references_parameters():
    assert [(n, tuple(p.shape)) for n, p in _model().named_parameters()] \
        == [(n, tuple(s)) for n, s, _ in ref.params(CFG)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64_TOL),
                                       (torch.float32, F32_TOL)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_port_matches_the_reference(dtype, tol, seed):
    w = _weights(seed, dtype)
    emb, seq, mask, y = _inputs(seed, dtype)
    z, loss, g = _port(w, emb, seq, mask, y, dtype)
    rz, rloss, rg = _reference(w, emb, seq, mask, y)
    assert z.dtype == dtype and g.keys() == rg.keys()
    _close(z, rz, tol)
    _close(loss, rloss, tol)
    for k in rg:
        assert float(rg[k].abs().max()) > 0, k  # every leaf is exercised
        _close(g[k], rg[k], tol)


def test_padded_slots_change_nothing():
    w = _weights(3, torch.float64)
    emb, seq, mask, y = _inputs(3, torch.float64)
    z, loss, g = _port(w, emb, seq, mask, y, torch.float64)
    gen = torch.Generator().manual_seed(9)
    noisy = {c: torch.where(mask[..., None], s,
                            torch.randn(s.shape, generator=gen,
                                        dtype=s.dtype))
             for c, s in seq.items()}
    z2, loss2, g2 = _port(w, emb, noisy, mask, y, torch.float64)
    _close(z2, z, 1e-13)
    _close(loss2, loss, 1e-13)
    for k in g:
        if k in seq:  # the padded slots take no gradient
            assert float(g2[k][~mask].abs().max()) == 0.0
        _close(g2[k], g[k], 1e-13)


def test_the_recency_rank_counts_the_valid_slots_after():
    """Slot ``t``'s position row is that of the valid slots at or after
    it (``n - t`` for a right-padded history), 0 at padding and for the
    candidate, holes in a history too; the reference ranks alike."""
    mask = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1],
                         [1, 0, 1, 1, 0, 0], [0, 1, 0, 0, 1, 0],
                         [1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0],
                         [1, 1, 0, 1, 0, 1], [1, 1, 1, 1, 1, 0]],
                        dtype=torch.bool)
    emb, seq, _, _ = _inputs(0, torch.float64)
    rank, keep = BST.ranks(mask)
    want = torch.tensor([[3, 2, 1, 0, 0, 0, 0], [6, 5, 4, 3, 2, 1, 0],
                         [3, 0, 2, 1, 0, 0, 0], [0, 2, 0, 0, 1, 0, 0],
                         [1, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0],
                         [4, 3, 0, 2, 0, 1, 0], [5, 4, 3, 2, 1, 0, 0]])
    assert torch.equal(rank, want)
    assert torch.equal(keep, torch.cat([mask, torch.ones((B, 1), dtype=bool)],
                                       1))
    # the reference, on the same holes
    w = _weights(0, torch.float64)
    _close(_port(w, emb, seq, mask, torch.zeros(B), torch.float64)[0],
           _reference(w, emb, seq, mask, torch.zeros(B))[0], F64_TOL)


def test_dropout_is_the_identity_in_eval():
    w = _weights(4, torch.float64)
    emb, seq, mask, y = _inputs(4, torch.float64)
    plain = _port(w, emb, seq, mask, y, torch.float64, train=False)
    dropped = _port(w, emb, seq, mask, y, torch.float64, train=False,
                    model=_model(dropout=0.5))
    assert torch.equal(plain[0], dropped[0])
    torch.manual_seed(0)
    a = _port(w, emb, seq, mask, y, torch.float64, train=True,
              model=_model(dropout=0.5))[0]
    assert not torch.equal(a, plain[0])  # training draws masks


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_in_training_scales_what_it_keeps(p):
    block = TransformerBlock(8, 2, 16, p)
    x = torch.randn((4000, 8), dtype=torch.float64) + 3.0
    torch.manual_seed(1)
    out = block._drop(x, True)
    kept = out != 0
    assert torch.allclose(out[kept], x[kept] / (1.0 - p), rtol=1e-15,
                          atol=0)
    assert abs(float(kept.double().mean()) - (1 - p)) < 0.02
    assert block._drop(x, False) is x
    assert TransformerBlock(8, 2, 16, 0.0)._drop(x, True) is x


ZOO = ["--batch_size", "32", "--emb_dim", "8", "--capacity", "8192",
       "--eval_steps", "1", "--synthetic_items", "500",
       "--synthetic_users", "50", "--prefetch_depth", "2",
       "--prefetch_workers", "2", "--log_steps", "100", "--max_len", "10",
       "--jit_cache", "", "--device", "cpu"]


def _zoo(argv):
    mod = importlib.import_module("deeprec_tpu_torch.modelzoo.BST.train")
    args = mod.parser().parse_args(ZOO + argv)
    return mod, args


@pytest.mark.parametrize("engine", [[], ["--host_index"]],
                         ids=["device_index", "host_index"])
def test_the_zoo_entry_trains_through_the_cli(engine):
    mod, args = _zoo(["--steps", "3"] + engine)
    assert (args.optimizer, args.learning_rate, args.dropout) == \
        ("adam", 0.001, None)
    spec = mod.build(args)
    block = spec.model.block
    assert (block.attention.heads, block.ffn_in.out_features,
            block.dropout) == (8, 96, mod.DROPOUT)
    assert [fc.out_features for fc in spec.model.fc] == [1024, 512, 256]
    assert spec.model.fc[0].in_features == 11 * 24 + 8
    out = cli.run(spec, args)
    assert out["model"] == "BST" and out["steps"] == 3
    assert 0.0 < out["train_loss"] < 10.0
    assert np.isfinite([out["train_auc"], out["eval_auc"]]).all()


def test_dropout_flag_reaches_the_block():
    mod, args = _zoo(["--dropout", "0"])
    assert mod.build(args).model.block.dropout == 0.0


def test_without_max_len_the_entry_and_its_streams_hold_100_slots():
    mod, args = _zoo([])
    args.max_len = None
    spec = mod.build(args)
    assert spec.model.max_len == mod.MAX_LEN == 100
    for data in (spec.train_data, spec.eval_data):
        assert next(iter(data(args)))["hist_item"].shape == (32, 100)


def _trainer(seed):
    mod, args = _zoo(["--seed", str(seed), "--dropout", "0"])
    return cli.make_trainer(mod.build(args), args)


def test_a_save_restores_the_dense_leaves_and_adam(tmp_path):
    batches = list(SyntheticBehavior(batch_size=32, max_len=10, n_items=500,
                                     n_users=50, seed=3).take(4))
    tr = _trainer(1)
    state = tr.init(batches[0])
    for b in batches[:2]:
        state = tr.train_step(state, b)
    CheckpointManager(str(tmp_path)).save(tr, state)
    tr2 = _trainer(2)
    state2, ok = CheckpointManager(str(tmp_path)).restore(
        tr2, tr2.init(batches[0]))
    assert ok and state2.step == state.step
    leaves = tctr.flax_leaves(tr.model)
    assert len(leaves) == len(list(tr.model.parameters()))
    for a, b in zip(leaves, tctr.flax_leaves(tr2.model)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a, b)
    # the next step agrees: the tables and Adam's dense state came back
    s1 = tr.train_step(state, batches[2])
    s2 = tr2.train_step(state2, batches[2])
    assert float(s1.metrics.loss_sum - state.metrics.loss_sum) == \
        pytest.approx(float(s2.metrics.loss_sum - state2.metrics.loss_sum),
                      rel=1e-6)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
