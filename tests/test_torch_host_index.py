"""Port parity: the host-index collection (resolver wire -> decode ->
lookup_or_create -> readonly_rows) against the JAX package's, on one
SyntheticCriteo stream, and the port's resolver binding against the JAX
package's."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data.criteo import CAT_NAMES, SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.utils import native as jnative

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

B, CAP, DIM = 256, 1 << 14, 8
COLS = CAT_NAMES[:8]
# The collection tests resolve with one hash group: there the C++ resolver
# and its Python fallback assign slots in the same order (at 16 groups the
# C++ one orders them by group first), so the comparison holds whichever
# one each side got. The 16-group order is held by the resolver test.
GROUPS = 1
LAYOUTS = {
    "light": {},
    # bench.py --metadata
    "metadata": dict(counter_filter=("CounterFilter", 1),
                     evict=("GlobalStepEvict", 1 << 30)),
    # an admission threshold that keeps keys out for a step
    "filter2": dict(counter_filter=("CounterFilter", 2),
                    evict=("GlobalStepEvict", 1 << 30)),
}


def _jax_native_lib():
    """The JAX package's resolver library. Its ``get_lib`` remembers a
    failed build for the whole process, and a build fails when several
    processes build at once (they share one temp file); when the library
    has appeared since, it is asked once more."""
    if jnative.get_lib() is None and os.path.exists(jnative._SO):
        jnative._tried = False
    return jnative.get_lib()


@pytest.mark.parametrize("native", [True, False])
def test_resolver_matches_jax_resolver(native):
    """Same keys, same resolves: bit-equal outputs, stats and wires (the
    port's build of the shared C++ source at 16 hash groups, or both
    fallbacks)."""
    if native and (_jax_native_lib() is None or tnative.get_lib() is None):
        pytest.skip("no C++ toolchain to build the resolver")
    kw = dict(n_groups=16 if native else 1, use_native=native)
    a, b = jnative.HostIndexResolver(**kw), tnative.HostIndexResolver(**kw)
    rng = np.random.default_rng(3)
    for step in range(6):
        keys = rng.choice(np.arange(-1, 400, dtype=np.int64), size=512)
        ro = step % 3 == 2
        for x, y in zip(a.resolve(keys, 64, 300, 300, readonly=ro),
                        b.resolve(keys, 64, 300, 300, readonly=ro)):
            assert np.array_equal(x, y)
        wa = a.resolve_wire(keys, 200, 300, 300, ro, True, True)
        wb = b.resolve_wire(keys, 200, 300, 300, ro, True, True)
        assert wa[0].tobytes() == wb[0].tobytes() and wa[1:] == wb[1:]
    assert a.stats() == b.stats()
    assert np.array_equal(a.export_keys(), b.export_keys())
    if native:  # built into the port's own build directory
        assert str(tnative.BUILD) in tnative.get_lib()._name


def _cfg_kw(mod, layout):
    kw = {}
    for k, (cls, arg) in LAYOUTS[layout].items():
        kw[k] = getattr(mod, cls)(arg)
    return kw


def _pair(layout):
    common = dict(name="emb", capacity=CAP, max_unique=len(COLS) * B // 6,
                  fused_slot_columns=DIM, fused_slot_init=0.1,
                  n_groups=GROUPS)
    j = JHost([jfc.EmbeddingColumn(jfc.CategoricalColumn(n), DIM)
               for n in COLS],
              initializer=dr.Initializer("normal", scale=0.05),
              **common, **_cfg_kw(dr, layout))
    t = THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
               for n in COLS],
              initializer=tcfg.Initializer("normal", scale=0.05),
              **common, **_cfg_kw(tcfg, layout))
    return j, t


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_host_index_collection_matches_jax(layout):
    jc, tc = _pair(layout)
    js, ts = jc.init(), tc.init("cpu")
    assert ts.values.device.type == "cpu"
    jlookup = jax.jit(jc.lookup_or_create)
    for step, batch in enumerate(SyntheticCriteo(batch_size=B,
                                                 seed=5).take(6)):
        jw, tw = jc.pack_ids(batch), tc.pack_ids(batch, "cpu")
        assert np.asarray(jw.buf).tobytes() == tw.buf.numpy().tobytes()
        jr, tr = jw.decode(), tw.decode()
        # integer fields bit-equal, every step
        jkeys64 = (np.asarray(jr.ukeys.hi).astype(np.int64) << 32) | \
            np.asarray(jr.ukeys.lo).astype(np.uint32).astype(np.int64)
        np.testing.assert_array_equal(tr.ukeys.numpy(), jkeys64)
        for f in ("uslots", "created", "counts", "inverse", "n_unique",
                  "n_overflow", "readonly"):
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jr, f)), f)

        js, jaux = jlookup(js, jw, jnp.asarray(step, jnp.int32))
        ts, taux = tc.lookup_or_create(ts, tw, step)
        for f in ("freqs", "versions", "create_steps"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        np.testing.assert_array_equal(taux.ev_aux.admitted.numpy(),
                                      np.asarray(jaux.ev_aux.admitted))
        # eager init (metadata layouts) writes normal init rows: the
        # Box-Muller log/cos agree to a few ulps (init_rows' tolerance)
        np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                                   rtol=0, atol=1e-6)
    if layout != "light":
        assert int((ts.freqs > 0).sum()) > 0
        assert int((ts.versions == 5).sum()) > 0

    # eval: find-only resolve, missing keys read their init row
    held = next(SyntheticCriteo(batch_size=B, seed=77).take(1))
    jaux, jrows = jc.readonly_rows(js, held)
    taux, trows = tc.readonly_rows(ts, held)
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(taux.ev_aux.admitted.numpy(),
                                  np.asarray(jaux.ev_aux.admitted))
    assert not taux.ev_aux.admitted.all()  # some keys were unseen
    assert tc._resolver.size == jc._resolver.size  # eval mutated nothing


META_LAYOUTS = {
    "metadata": LAYOUTS["metadata"],   # versions, freqs, filter 1
    "filter2": LAYOUTS["filter2"],     # a filter that holds keys out
    "versions": dict(evict=("GlobalStepEvict", 1 << 30)),  # no filter
    "freqs": dict(track_freq=True),    # freqs counted, no filter
    # the filter reads a freq plane that nothing counts
    "filter_uncounted": dict(counter_filter=("CounterFilter", 1),
                             track_freq=False),
}


@pytest.mark.parametrize("layout", list(META_LAYOUTS))
def test_lookup_meta_plain_matches_jax_lookup(layout):
    """K3a's plain function on the port's resolved batch gives the JAX
    lookup_or_create's metadata planes and admitted mask, bit-equal, over
    train resolves and one eval (readonly) resolve."""
    from deeprec_tpu_torch.ops.meta_scatter import lookup_meta_plain

    def kw(mod):
        return {k: getattr(mod, v[0])(v[1]) if isinstance(v, tuple) else v
                for k, v in META_LAYOUTS[layout].items()}
    common = dict(name="emb", capacity=CAP, max_unique=len(COLS) * B // 6,
                  n_groups=GROUPS)
    jc = JHost([jfc.EmbeddingColumn(jfc.CategoricalColumn(n), DIM)
                for n in COLS], **common, **kw(dr))
    tc = THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
                for n in COLS], **common, **kw(tcfg))
    cfg = tc.config
    vt, ft, cf = cfg.version_tracked, cfg.freq_tracked, cfg.counter_filter
    js, ts = jc.init(), tc.init("cpu")
    jlookup = jax.jit(jc.lookup_or_create)
    batches = list(SyntheticCriteo(batch_size=B, seed=9).take(5))
    for step, batch in enumerate(batches):
        eval_step = step == 3
        jw = jc.pack_ids_eval(batch) if eval_step else jc.pack_ids(batch)
        r = (tc.pack_ids_eval if eval_step else tc.pack_ids)(batch,
                                                             "cpu").decode()
        assert bool(r.readonly) == eval_step
        js, jaux = jlookup(js, jw, jnp.asarray(step, jnp.int32))
        dest = torch.where(r.created & ~r.readonly, r.uslots, CAP + 1)
        admitted = lookup_meta_plain(
            r.uslots, r.counts, r.readonly, dest, step, CAP,
            ts.create_steps if vt else None, ts.versions if vt else None,
            ts.freqs, ft, None if cf is None else cf.filter_freq)
        for f in ("freqs", "versions", "create_steps"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        np.testing.assert_array_equal(admitted.numpy(),
                                      np.asarray(jaux.ev_aux.admitted))
    if ft:
        assert int((ts.freqs > 0).sum()) > 0
    if vt:
        assert int((ts.versions == 4).sum()) > 0
    if cf is not None and cf.filter_freq > 1 and ft:
        assert not admitted[r.uslots != CAP].all()  # the filter held some


@pytest.mark.parametrize("entry", ["ev.create", "ht.create", "Predictor",
                                   "TieredPredictor",
                                   "HostIndexEmbeddingCollection.init",
                                   "Trainer", "HostStepPipeline"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """With no device named, each entry point puts its tensors on the card,
    and without one it raises: nothing moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this checks the default on a machine without a card")
    from deeprec_tpu_torch.models.ctr import DLRM
    from deeprec_tpu_torch.optim.dense import Adagrad
    from deeprec_tpu_torch.serving import Predictor, TieredPredictor
    from deeprec_tpu_torch.sparse import embedding_var as tev
    from deeprec_tpu_torch.sparse import hashtable as tht
    from deeprec_tpu_torch.train.pipeline import HostStepPipeline
    from deeprec_tpu_torch.train.trainer import Trainer
    _, tc = _pair("light")
    model = DLRM(COLS, DIM, bottom_units=(8,), top_units=(8,))
    call = {
        "ev.create": lambda: tev.create(tc.config),
        "ht.create": lambda: tht.create(64),
        "Predictor": lambda: Predictor(model, [], {}, str(tmp_path)),
        "TieredPredictor": lambda: TieredPredictor(model, [], {},
                                                   str(tmp_path), 8),
        "HostIndexEmbeddingCollection.init": tc.init,
        "Trainer": lambda: Trainer(model, [], {}, {}, Adagrad()),
        "HostStepPipeline": lambda: HostStepPipeline(lambda x: x),
    }[entry]
    with pytest.raises((RuntimeError, AssertionError)):
        call()
