"""DCN-v2 Criteo trainer.

Port of ``modelzoo/DCN/train.py``: cross network + deep tower in
parallel over [dense, embeddings]; ``--bf16`` runs both in bfloat16.
"""
import torch

from ... import feature_column as fc
from ...config import Initializer
from ...data.criteo import CAT_NAMES, DENSE_NAMES
from ...models import ctr
from ...train import cli


def build(args) -> cli.ModelSpec:
    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), args.emb_dim)
            for n in CAT_NAMES]
    coll = cli.collection_cls(args)(
        cols, name="emb", capacity=args.capacity,
        initializer=Initializer("normal", scale=0.05), **cli.ev_kwargs(args))
    model = ctr.DCN(
        emb_names=[c.name for c in cols], emb_dim=args.emb_dim,
        cross_layers=3, deep_units=(1024, 512, 256), dense_dim=len(numeric),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    return cli.ModelSpec(
        name="DCN", model=model, numeric_columns=numeric,
        collections={"emb": coll},
        sparse_optimizers={"emb": cli.make_sparse_opt(args)},
        train_data=cli.criteo_train_stream,
        eval_data=cli.criteo_eval_stream)


if __name__ == "__main__":
    args = cli.base_parser("DCN-v2 on Criteo").parse_args()
    cli.run(build(args), args)
