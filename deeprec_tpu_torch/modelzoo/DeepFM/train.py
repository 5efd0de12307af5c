"""DeepFM Criteo trainer.

Port of ``modelzoo/DeepFM/train.py``: first-order wide weights
(FTRL) + second-order FM over the embedding stack + deep MLP, summed into
one logit; ``--bf16`` runs the deep MLP in bfloat16.
"""
import torch

from ... import feature_column as fc
from ...config import Initializer
from ...data.criteo import CAT_NAMES, DENSE_NAMES
from ...models import ctr
from ...optim import sparse as sopt
from ...train import cli


def build(args) -> cli.ModelSpec:
    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), args.emb_dim)
            for n in CAT_NAMES]
    wide_cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 1)
                 for n in CAT_NAMES]
    ev = cli.ev_kwargs(args)
    coll = cli.collection_cls(args)(
        cols, name="emb", capacity=args.capacity,
        initializer=Initializer("normal", scale=0.05), **ev)
    wide = cli.collection_cls(args)(
        wide_cols, name="wide", capacity=args.capacity,
        initializer=Initializer("zeros"), **ev)
    model = ctr.DeepFM(
        emb_names=[c.name for c in cols],
        wide_names=[c.name for c in wide_cols], emb_dim=args.emb_dim,
        deep_units=(400, 400, 400), dense_dim=len(numeric),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    return cli.ModelSpec(
        name="DeepFM", model=model, numeric_columns=numeric,
        collections={"emb": coll, "wide": wide},
        sparse_optimizers={"emb": cli.make_sparse_opt(args),
                           "wide": sopt.sparse_ftrl(args.learning_rate)},
        train_data=cli.criteo_train_stream,
        eval_data=cli.criteo_eval_stream)


if __name__ == "__main__":
    args = cli.base_parser("DeepFM on Criteo").parse_args()
    cli.run(build(args), args)
