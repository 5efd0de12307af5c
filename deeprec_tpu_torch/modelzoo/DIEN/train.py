"""DIEN trainer: GRU interest extraction + AUGRU interest evolution.

Port of ``modelzoo/DIEN/train.py``: GRU
states over the behaviour sequence, attention vs. the candidate, AUGRU
final interest, with the auxiliary next-behaviour loss in training
(``models.sequence.dien_forward``, weight 1.0). No ``--bf16`` policy, as
in the JAX model.
"""
from ... import feature_column as fc
from ...config import Initializer
from ...models import sequence
from ...train import cli

MAX_LEN = 32
dien_forward = sequence.dien_forward


def build(args) -> cli.ModelSpec:
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
            fc.CategoricalColumn("hist_item", max_length=MAX_LEN,
                                 shared_embedding="item_space"),
            args.emb_dim),
        fc.SequenceEmbeddingColumn(
            fc.CategoricalColumn("hist_cate", max_length=MAX_LEN,
                                 shared_embedding="cate_space"),
            args.emb_dim),
    ]
    coll = cli.collection_cls(args)(
        cols, name="emb", capacity=args.capacity,
        initializer=Initializer("normal", scale=0.05), **cli.ev_kwargs(args))
    model = sequence.DIEN(
        candidate_name="item", seq_name="hist_item", emb_dim=args.emb_dim,
        candidate_context_names=["cate"], seq_context_names=["hist_cate"],
        context_names=["uid"], gru_units=2 * args.emb_dim,
        hidden_units=(200, 80), att_units=(80, 40), use_aux_loss=True)
    return cli.ModelSpec(
        name="DIEN", model=model, numeric_columns=[],
        collections={"emb": coll},
        sparse_optimizers={"emb": cli.make_sparse_opt(args)},
        train_data=cli.behavior_train_stream,
        eval_data=cli.behavior_eval_stream,
        forward=dien_forward, aux_loss_weight=1.0)


def parser():
    p = cli.base_parser("DIEN on behaviour data")
    p.set_defaults(optimizer="adam", learning_rate=0.002,
                   # behaviour sequences dedup poorly: most
                   # history ids are unique within a batch
                   max_unique_ratio=0.75)
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    cli.run(build(args), args)
