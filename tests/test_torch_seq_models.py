"""Port parity for the sequence models' dense side: Dice (train statistics,
running update, eval on the running statistics), DINAttention,
DINAttentionScores, GRU and AUGRU over ragged masks, DIN (dice and relu)
and DIEN (logits and auxiliary loss) against the flax modules, with flax
variables carried across by load_flax_params: forward outputs, the
batch_stats a train pass leaves, and the gradients with respect to the
parameters and to the sequence inputs. The flax path lists, batch_stats
first, are jax.tree_util's; the dense optimizers' optax leaves over such
a variables tree are optax's, and a state whose batch_stats leaves moved
is refused."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeprec_tpu.models import layers as jlayers
from deeprec_tpu.models import sequence as jseq

from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.models import layers as tlayers
from deeprec_tpu_torch.models import sequence as tseq
from deeprec_tpu_torch.optim import dense as tdense

torch.set_num_threads(1)

B, L, DIM, GRU_UNITS = 16, 8, 8, 16
HIDDEN, ATT = (16, 8), (8, 4)
# f32 products and sums in another order; DIEN's two 8-step recurrences
# and its gradients compound the relative error of each step
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = dict(candidate_name="item", seq_name="hist_item",
             candidate_context_names=["cate"],
             seq_context_names=["hist_cate"], context_names=["uid"],
             hidden_units=HIDDEN, att_units=ATT)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _mask(rng):
    """Ragged prefixes: one full row, one of length 1, the rest random."""
    lens = rng.integers(1, L + 1, B)
    lens[0], lens[1] = L, 1
    return np.arange(L)[None, :] < lens[:, None]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, ref, tol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, err_msg=what, **tol)


def _carry(variables, tm):
    tctr.load_flax_params(tm, [np.asarray(x) for x in
                               jax.tree_util.tree_leaves(variables)])


def _paths(variables):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(variables)[0]]


def _port_paths(tm, variables):
    """The port's flax paths, and jax.tree_util's of the variables: the
    whole dict when it has batch_stats, else its params (the port names
    a model without running statistics by its params tree alone)."""
    ref = variables if "batch_stats" in variables else variables["params"]
    return [p for p, _, _ in tctr._flax_params(tm)], _paths(ref)


def _grads_match(tm, jgrads, tol, what):
    """The port's parameter gradients as a variables-shaped tree (0 at the
    batch_stats leaves, which a train pass never reads) against JAX's."""
    got = tctr.flax_state_leaves(
        tm, [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in tm.parameters()])
    ref = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(ref)
    for path, g, r in zip(_paths(jgrads), got, ref):
        _close(g, r, tol, f"{what} d{path}")


def test_dice_matches_flax():
    """Mirrors tests/test_model_fidelity.py: train passes move the running
    statistics as flax's do (population variance, momentum 0.99); eval
    reads them, so a row's output does not depend on its batch."""
    x0 = _rng(0).normal(size=(32, 4)).astype(np.float32)
    jd, td = jlayers.Dice(), tlayers.Dice(4)
    variables = jd.init(jax.random.key(0), jnp.asarray(x0), train=True)
    # a non-zero alpha, so the gate's both branches count
    variables = {"batch_stats": variables["batch_stats"],
                 "params": {"alpha": jnp.linspace(-0.5, 0.5, 4)}}
    _carry(variables, td)
    got, ref = _port_paths(td, variables)
    assert got == ref and ref[0] == "['batch_stats']['mean']"
    for i in range(10):
        xi = _rng(i).normal(2.0, 3.0, size=(32, 4)).astype(np.float32)
        out, upd = jd.apply(variables, jnp.asarray(xi), train=True,
                            mutable=["batch_stats"])
        _close(td(torch.from_numpy(xi), train=True), out, FWD_TOL, f"y{i}")
        variables = {**variables, **upd}
        for k in ("mean", "var"):
            _close(getattr(td, k), variables["batch_stats"][k], FWD_TOL, k)
    assert np.all(td.mean.numpy() > 0.1)  # moved toward the stream's 2.0

    # eval: the running statistics, whatever the rest of the batch
    row = _rng(99).normal(size=(1, 4)).astype(np.float32)
    crowd = np.concatenate([row, np.full((31, 4), 50.0, np.float32)])
    before = [td.mean.clone(), td.var.clone()]
    alone = td(torch.from_numpy(row))
    together = td(torch.from_numpy(crowd))
    _close(together, jd.apply(variables, jnp.asarray(crowd), train=False),
           FWD_TOL, "eval")
    np.testing.assert_allclose(_np(alone), _np(together)[:1], rtol=1e-6)
    assert torch.equal(td.mean, before[0]) and torch.equal(td.var, before[1])

    # gradients through the batch statistics, to alpha and to the input
    x = torch.from_numpy(x0).requires_grad_(True)
    w = _rng(5).normal(size=(32, 4)).astype(np.float32)
    (td(x, train=True) * torch.from_numpy(w)).sum().backward()

    def loss(p, xx):
        y, _ = jd.apply({**variables, "params": p}, xx, train=True,
                        mutable=["batch_stats"])
        return jnp.sum(y * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x0))
    _close(td.alpha.grad, gp["alpha"], GRAD_TOL, "dalpha")
    _close(x.grad, gx, GRAD_TOL, "dx")


def _attention_inputs(seed, d):
    rng = _rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    k = rng.normal(size=(B, L, d)).astype(np.float32)
    return q, k, _mask(rng)


@pytest.mark.parametrize("kind", ["din_attention", "scores"])
def test_attention_matches_flax(kind):
    """DINAttention (pooled [B, d], scores over sqrt(d)) and
    DINAttentionScores (the weights, unscaled): forward and gradients."""
    jm, tm = ((jlayers.DINAttention(ATT), tlayers.DINAttention(DIM, ATT))
              if kind == "din_attention" else
              (jseq.DINAttentionScores(ATT),
               tseq.DINAttentionScores(DIM, ATT)))
    q, k, m = _attention_inputs(1, DIM)
    variables = jm.init(jax.random.key(0), jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(m))
    _carry(variables, tm)
    got, ref = _port_paths(tm, variables)
    assert got == ref
    tq, tk = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    out = tm(tq, tk, torch.from_numpy(m))
    ref = jm.apply(variables, jnp.asarray(q), jnp.asarray(k),
                   jnp.asarray(m))
    _close(out, ref, FWD_TOL, "out")
    if kind == "scores":  # padded positions weigh nothing; rows sum to 1
        assert bool((out[~torch.from_numpy(m)] == 0).all())
        _close(out.sum(-1), np.ones(B, np.float32), FWD_TOL, "sum")

    w = _rng(7).normal(size=out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    gp, gq, gk = jax.grad(
        lambda p, a, b: jnp.sum(jm.apply(p, a, b, jnp.asarray(m)) * w),
        argnums=(0, 1, 2))(variables, jnp.asarray(q), jnp.asarray(k))
    _grads_match(tm, gp, GRAD_TOL, kind)
    _close(tq.grad, gq, GRAD_TOL, "dquery")
    _close(tk.grad, gk, GRAD_TOL, "dkeys")


@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_recurrent_matches_flax(kind):
    """GRU (every state) and AUGRU (the last state) over ragged masks: a
    padded step holds the state; forward and gradients to the parameters,
    the sequence and the attention weights."""
    rng = _rng(2)
    xs = rng.normal(size=(B, L, DIM)).astype(np.float32)
    att = rng.random((B, L)).astype(np.float32)
    m = _mask(rng)
    if kind == "gru":
        jm, tm = jlayers.GRU(GRU_UNITS), tlayers.GRU(DIM, GRU_UNITS)
        jargs = (jnp.asarray(xs), jnp.asarray(m))
    else:
        jm, tm = jlayers.AUGRU(GRU_UNITS), tlayers.AUGRU(DIM, GRU_UNITS)
        jargs = (jnp.asarray(xs), jnp.asarray(att), jnp.asarray(m))
    variables = jm.init(jax.random.key(0), *jargs)
    _carry(variables, tm)
    got, ref = _port_paths(tm, variables)
    assert got == ref
    txs = torch.from_numpy(xs).requires_grad_(True)
    tatt = torch.from_numpy(att).requires_grad_(True)
    targs = ((txs, torch.from_numpy(m)) if kind == "gru"
             else (txs, tatt, torch.from_numpy(m)))
    out = tm(*targs)
    _close(out, jm.apply(variables, *jargs), FWD_TOL, "out")
    if kind == "gru":  # a padded step repeats the state before it
        lens = m.sum(1)
        for b in np.flatnonzero(lens < L):
            assert torch.equal(out[b, lens[b]:],
                               out[b, lens[b] - 1].expand(L - lens[b], -1))

    w = rng.normal(size=out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    grads = jax.grad(lambda p, *a: jnp.sum(jm.apply(p, *a) * w),
                     argnums=tuple(range(len(jargs))))(variables, *jargs)
    _grads_match(tm, grads[0], GRAD_TOL, kind)
    _close(txs.grad, grads[1], GRAD_TOL, "dxs")
    if kind == "augru":
        _close(tatt.grad, grads[2], GRAD_TOL, "datt")


def _models(kind):
    if kind == "dien":
        return (jseq.DIEN(gru_units=GRU_UNITS, **NAMES),
                tseq.DIEN(emb_dim=DIM, gru_units=GRU_UNITS, **NAMES))
    act = kind.split("_")[1]
    return (jseq.DIN(activation=act, **NAMES),
            tseq.DIN(emb_dim=DIM, activation=act, **NAMES))


def _model_inputs(seed):
    """Pooled embeddings and two histories sharing one ragged mask; the
    padded positions hold values too (the models must mask them, and
    DIEN's negatives read them)."""
    rng = _rng(seed)
    emb = {n: rng.normal(size=(B, DIM)).astype(np.float32)
           for n in ("item", "cate", "uid")}
    m = _mask(rng)
    seq = {n: (rng.normal(size=(B, L, DIM)).astype(np.float32), m)
           for n in ("hist_item", "hist_cate")}
    return emb, seq


def _as_jax(emb, seq):
    return ({k: jnp.asarray(v) for k, v in emb.items()},
            {k: (jnp.asarray(a), jnp.asarray(m)) for k, (a, m) in seq.items()})


def _as_torch(emb, seq, grad=False):
    return ({k: torch.from_numpy(v) for k, v in emb.items()},
            {k: (torch.from_numpy(a.copy()).requires_grad_(grad),
                 torch.from_numpy(m)) for k, (a, m) in seq.items()})


@pytest.mark.parametrize("kind", ["din_dice", "din_relu", "dien"])
def test_model_matches_flax(kind):
    """DIN and DIEN with flax variables carried in: the flax path list
    (batch_stats first), train logits, DIEN's auxiliary loss, the
    batch_stats a train pass leaves, gradients to the parameters and to
    the histories, and eval logits on the moved statistics."""
    jm, tm = _models(kind)
    aux = {"return_aux": True} if kind == "dien" else {}
    emb, seq = _model_inputs(3)
    jemb, jsq = _as_jax(emb, seq)
    variables = jm.init(jax.random.key(0), None, jemb, jsq, train=True,
                        **aux)
    _carry(variables, tm)
    got, ref = _port_paths(tm, variables)
    assert got == ref
    assert ("batch_stats" in variables) == (kind != "din_relu")
    for a, b in zip(tctr.flax_leaves(tm),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))
    if kind == "din_dice":  # DIN's tower input at the zoo's widths
        assert tseq.DIN(emb_dim=16, **NAMES).fc[0].in_features == 144
    if kind == "dien":
        assert tseq.DIEN(emb_dim=16, gru_units=32,
                         **NAMES).fc[0].in_features == 112

    w = _rng(4).normal(size=B).astype(np.float32)

    def jloss(v, hists):
        s = {k: (hists[k], jsq[k][1]) for k in jsq}
        out, upd = jm.apply(v, None, jemb, s, train=True,
                            mutable=["batch_stats"], **aux)
        logits, al = out if kind == "dien" else (out, 0.0)
        return jnp.sum(logits * w) + al, (out, upd)
    (_, (jout, upd)), (gv, gs) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            variables, {k: a for k, (a, _) in jsq.items()})

    temb, tsq = _as_torch(emb, seq, grad=True)
    tout = tm(None, temb, tsq, train=True, **aux)
    tlogits, tal = tout if kind == "dien" else (tout, 0.0)
    if kind == "dien":
        _close(tal, jout[1], FWD_TOL, "aux loss")
        _close(tlogits, jout[0], FWD_TOL, "logits")
    else:
        _close(tlogits, jout, FWD_TOL, "logits")
    ((tlogits * torch.from_numpy(w)).sum() + tal).backward()
    _grads_match(tm, gv, GRAD_TOL, kind)
    for n in seq:
        _close(tsq[n][0].grad, gs[n], GRAD_TOL, f"d{n}")
    if kind != "din_relu":  # the statistics the train pass left
        moved = {**variables, **upd}
        n_bs = len(jax.tree_util.tree_leaves(upd))
        assert n_bs == 2 * len(HIDDEN)
        for g, r in zip(tctr.flax_leaves(tm)[:n_bs],
                        jax.tree_util.tree_leaves(upd)):
            _close(g, r, FWD_TOL, "batch_stats")
        assert not np.allclose(np.asarray(
            jax.tree_util.tree_leaves(upd)[0]), 0.0)
    else:
        moved = variables

    # eval: no auxiliary loss, the running statistics
    emb2, seq2 = _model_inputs(8)
    ref = jm.apply(moved, None, *_as_jax(emb2, seq2), train=False)
    with torch.no_grad():
        got = tm(None, *_as_torch(emb2, seq2), train=False)
    _close(got, ref, FWD_TOL, "eval logits")


def test_dien_aux_loss_reads_the_previous_examples_padding():
    """The negatives roll the history over the batch: example b's valid
    position t scores example b-1's row t, padded or not, so the padded
    rows' values reach the loss (the port must feed the values JAX feeds:
    zeros from the null row, in training)."""
    jm, tm = _models("dien")
    emb, seq = _model_inputs(3)
    jemb, jsq = _as_jax(emb, seq)
    variables = jm.init(jax.random.key(0), None, jemb, jsq, train=True,
                        return_aux=True)
    _carry(variables, tm)
    m = seq["hist_item"][1]
    b = 1 + int(np.flatnonzero((~m[:-1]).any(1) & m[1:].all(1))[0])
    t = int(np.flatnonzero(~m[b - 1])[0])  # padded in b-1, valid in b
    other = {k: (a.copy(), mm) for k, (a, mm) in seq.items()}
    other["hist_item"][0][b - 1, t] += 1.0
    with torch.no_grad():
        base = tm(None, *_as_torch(emb, seq), train=False,
                  return_aux=True)[1]
        moved = tm(None, *_as_torch(emb, other), train=False,
                   return_aux=True)[1]
    ref = jm.apply(variables, None, *_as_jax(emb, other), train=False,
                   return_aux=True)[1]
    assert float(moved) != float(base)
    _close(moved, ref, FWD_TOL, "aux loss")


@pytest.mark.parametrize("which", ["adam", "adagrad"])
def test_dense_state_over_batch_stats(which):
    """optax over DIN's whole variables dict keeps leaves for the
    batch_stats, which never get a gradient: the port's optimizer leaves
    (Adam's count, mu, nu; Adagrad's sums) are optax's over 5 steps, the
    statistics' leaves at the initial value; a state whose statistics'
    leaves moved, or of the wrong count, is refused."""
    jm, tm = _models("din_dice")
    emb, seq = _model_inputs(3)
    variables = jm.init(jax.random.key(0), None, *_as_jax(emb, seq),
                        train=True)
    _carry(variables, tm)
    jopt = optax.adam(0.002) if which == "adam" else optax.adagrad(0.05)
    topt = tdense.Adam(0.002) if which == "adam" else tdense.Adagrad(0.05)
    jstate, tstate = jopt.init(variables), topt.init(list(tm.parameters()))
    n = len(jax.tree_util.tree_leaves(variables))
    assert n == 18 and topt.state_leaf_count(n) == len(
        jax.tree_util.tree_leaves(jstate))
    treedef = jax.tree_util.tree_structure(variables)
    rng = _rng(6)
    for _ in range(5):
        # the batch_stats' gradient is 0, as in a train pass
        gl = [np.zeros(np.shape(x), np.float32) if p.startswith(
                  "['batch_stats']")
              else rng.normal(size=np.shape(x)).astype(np.float32)
              for p, x in zip(_paths(variables),
                              jax.tree_util.tree_leaves(variables))]
        upd, jstate = jopt.update(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g) for g in gl]), jstate, variables)
        variables = optax.apply_updates(variables, upd)
        for p, g in zip(tm.parameters(), tctr.load_flax_state(tm, gl)):
            p.grad = g
        topt.step(list(tm.parameters()), tstate)
    got = topt.flax_state_leaves(tm, tstate)
    ref = jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(tctr.flax_leaves(tm),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    back = topt.load_flax_state(tm, got)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(tuple(tstate))):
        assert torch.equal(a, b)

    # a moved statistic's leaf (the first mu / sum leaf is dice_0's mean)
    bad = [x.copy() for x in got]
    bad[1 if which == "adam" else 0][0] = 0.5
    with pytest.raises(ValueError, match="running statistic"):
        topt.load_flax_state(tm, bad)
    with pytest.raises(ValueError, match="leaves for"):
        topt.load_flax_state(tm, got[:len(got) // 2])
