"""Write the DeepRec-shaped TensorBundle fixture under
``tests/torch_fixtures/deeprec_bundle/`` (``model.ckpt-1000``).

The bundle is what a DeepRec DLRM job over the 26 Criteo columns saves:
one EmbeddingVariable quad (``-keys``, ``-values``, ``-versions``,
``-freqs``) per column, ``dlrm/C<i>/embedding``, 128 keys at dim 16
(``C1`` partitioned into ``part_0`` and ``part_1``); an ``Adagrad`` slot EV
of ``C1`` that dumps its keys in its own order and misses some; the bottom
MLP's kernels and biases (13 -> 512 -> 256 -> 16, flax's ``[in, out]``
kernels); ``global_step``; and a string tensor, which readers skip.

:func:`fixture_arrays` builds every array from a seed with numpy alone, so
a reader can be held to them where TensorFlow is not installed. Writing
needs TensorFlow (``tf.raw_ops.SaveV2``, the op DeepRec's Saver lowers
to)::

    python tests/torch_fixtures/make_bundle.py
"""
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX = os.path.join(HERE, "deeprec_bundle", "model.ckpt-1000")
SEED = 2026
N_COLUMNS, N_KEYS, DIM = 26, 128, 16
BOTTOM = (13, 512, 256, 16)  # dense features -> bottom MLP -> emb dim
N_SLOT = 100                 # C1's Adagrad slot EV misses 28 keys


def ev_name(column: int) -> str:
    return f"dlrm/C{column}/embedding"


def bottom_names():
    """``(bundle name, flax path of the port's DLRM)`` of each bottom-MLP
    tensor: ``dense_0``, ``dense_1`` and the ``head`` to the emb dim."""
    layers = ["dense_0", "dense_1", "head"]
    return [(f"dlrm/bottom_mlp/{layer}/{leaf}",
             f"['params']['MLPTower_0']['{layer}']['{leaf}']")
            for layer in layers for leaf in ("kernel", "bias")]


def fixture_arrays():
    """Every tensor of the bundle: ``{"evs": {column: {keys, values,
    versions, freqs}}, "slot": {keys, values}, "dense": {name: array},
    "global_step": int}``, drawn from :data:`SEED`."""
    rng = np.random.default_rng(SEED)
    evs = {}
    for c in range(1, N_COLUMNS + 1):
        keys = np.concatenate([
            rng.choice(1 << 20, N_KEYS // 2, replace=False),
            rng.choice(1 << 40, N_KEYS // 4, replace=False) + (1 << 33),
            -rng.choice(1 << 30, N_KEYS // 4, replace=False) - 2])
        evs[c] = {"keys": keys.astype(np.int64),
                  "values": (rng.standard_normal((N_KEYS, DIM)) * 0.05)
                  .astype(np.float32),
                  "versions": rng.integers(0, 1000, N_KEYS).astype(np.int64),
                  "freqs": rng.integers(1, 100, N_KEYS).astype(np.int64)}
    perm = rng.permutation(N_KEYS)[:N_SLOT]
    slot = {"keys": evs[1]["keys"][perm],
            "values": rng.uniform(0.1, 2.0, (N_SLOT, DIM)).astype(np.float32)}
    dense = {}
    for i, (name, _) in enumerate(bottom_names()):
        fan_in, fan_out = BOTTOM[i // 2], BOTTOM[i // 2 + 1]
        shape = (fan_in, fan_out) if name.endswith("kernel") else (fan_out,)
        dense[name] = (rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5
                       ).astype(np.float32)
    return {"evs": evs, "slot": slot, "dense": dense, "global_step": 1000}


def _quad(name, ev, rows=slice(None)):
    return [(f"{name}-{f}", ev[f][rows])
            for f in ("keys", "values", "versions", "freqs")]


def main():
    import tensorflow as tf
    a = fixture_arrays()
    tensors = []
    half = N_KEYS // 2
    tensors += _quad(ev_name(1) + "/part_0", a["evs"][1], slice(0, half))
    tensors += _quad(ev_name(1) + "/part_1", a["evs"][1], slice(half, None))
    n = N_SLOT
    tensors += _quad(ev_name(1) + "/Adagrad", {
        "keys": a["slot"]["keys"], "values": a["slot"]["values"],
        "versions": np.zeros(n, np.int64), "freqs": np.ones(n, np.int64)})
    for c in range(2, N_COLUMNS + 1):
        tensors += _quad(ev_name(c), a["evs"][c])
    tensors += sorted(a["dense"].items())
    tensors.append(("global_step", np.int64(a["global_step"])))
    os.makedirs(os.path.dirname(PREFIX), exist_ok=True)
    tf.raw_ops.SaveV2(
        prefix=PREFIX, tensor_names=[t[0] for t in tensors] + ["ckpt/path"],
        shape_and_slices=[""] * (len(tensors) + 1),
        tensors=[tf.constant(t[1]) for t in tensors]
        + [tf.constant("unused-string")])
    print(PREFIX)


if __name__ == "__main__":
    main()
