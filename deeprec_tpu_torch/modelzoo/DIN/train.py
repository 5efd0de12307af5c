"""DIN trainer: attention pooling over the behaviour sequence.

Port of ``modelzoo/DIN/train.py``: the candidate
item embedding attends over the clicked-item history (DIN local activation
unit), Dice activations in the MLP. Candidate and history share the item
embedding space. No ``--bf16`` policy, as in the JAX model.

Histories hold ``--max_len`` positions, or ``MAX_LEN`` (read when
:func:`build` runs) without it.
"""
from ... import feature_column as fc
from ...config import Initializer
from ...models import sequence
from ...train import cli

MAX_LEN = 32


def build(args) -> cli.ModelSpec:
    max_len = args.max_len or MAX_LEN
    cols = [
        fc.EmbeddingColumn(
            fc.CategoricalColumn("item", shared_embedding="item_space"),
            args.emb_dim),
        # candidate cate and history cates share rows (cate_space)
        fc.EmbeddingColumn(
            fc.CategoricalColumn("cate", shared_embedding="cate_space"),
            args.emb_dim),
        fc.EmbeddingColumn(fc.CategoricalColumn("uid"), args.emb_dim),
        fc.SequenceEmbeddingColumn(
            fc.CategoricalColumn("hist_item", max_length=max_len,
                                 shared_embedding="item_space"),
            args.emb_dim),
        fc.SequenceEmbeddingColumn(
            fc.CategoricalColumn("hist_cate", max_length=max_len,
                                 shared_embedding="cate_space"),
            args.emb_dim),
    ]
    coll = cli.collection_cls(args)(
        cols, name="emb", capacity=args.capacity,
        initializer=Initializer("normal", scale=0.05), **cli.ev_kwargs(args))
    model = sequence.DIN(
        candidate_name="item", seq_name="hist_item", emb_dim=args.emb_dim,
        # attention over per-position [item; cate] against [cand; cate]
        candidate_context_names=["cate"], seq_context_names=["hist_cate"],
        context_names=["uid"],
        hidden_units=(200, 80), att_units=(80, 40))
    return cli.ModelSpec(
        name="DIN", model=model, numeric_columns=[],
        collections={"emb": coll},
        sparse_optimizers={"emb": cli.make_sparse_opt(args)},
        train_data=cli.behavior_train_stream,
        eval_data=cli.behavior_eval_stream)


def parser():
    p = cli.base_parser("DIN on behaviour data")
    p.set_defaults(optimizer="adam", learning_rate=0.002,
                   # behaviour sequences dedup poorly: most
                   # history ids are unique within a batch
                   max_unique_ratio=0.75)
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    cli.run(build(args), args)
