"""DSSM two-tower trainer on behaviour data.

Port of ``modelzoo/DSSM/train.py``: user tower over
[uid, mean-pooled click history], item tower over [candidate item,
category]; logit = scaled cosine similarity. The history shares the item
embedding space with the candidate; ``--bf16`` runs the towers in
bfloat16.
"""
import torch

from ... import feature_column as fc
from ...config import Initializer
from ...models import ctr
from ...train import cli

MAX_LEN = 32


def build(args) -> cli.ModelSpec:
    cols = [
        fc.EmbeddingColumn(fc.CategoricalColumn("uid"), args.emb_dim),
        fc.EmbeddingColumn(
            fc.CategoricalColumn("item", shared_embedding="item_space"),
            args.emb_dim),
        fc.EmbeddingColumn(fc.CategoricalColumn("cate"), args.emb_dim),
        fc.EmbeddingColumn(
            fc.CategoricalColumn("hist_item", max_length=MAX_LEN,
                                 shared_embedding="item_space"),
            args.emb_dim, combiner="mean"),
    ]
    coll = cli.collection_cls(args)(
        cols, name="emb", capacity=args.capacity,
        initializer=Initializer("normal", scale=0.05), **cli.ev_kwargs(args))
    model = ctr.DSSM(
        user_emb_names=["uid", "hist_item"],
        item_emb_names=["item", "cate"], emb_dim=args.emb_dim,
        tower_units=(256, 128), out_dim=64,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    return cli.ModelSpec(
        name="DSSM", model=model, numeric_columns=[],
        collections={"emb": coll},
        sparse_optimizers={"emb": cli.make_sparse_opt(args)},
        train_data=cli.behavior_train_stream,
        eval_data=cli.behavior_eval_stream)


def parser():
    p = cli.base_parser("DSSM two-tower on behaviour data")
    p.set_defaults(optimizer="adam", learning_rate=0.002,
                   # behaviour sequences dedup poorly: most
                   # history ids are unique within a batch
                   max_unique_ratio=0.75)
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    cli.run(build(args), args)
