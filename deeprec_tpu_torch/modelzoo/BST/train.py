"""BST trainer: a transformer block over the behaviour sequence and the
candidate.

The port's own entry (the JAX package has no BST): Chen et al.,
"Behavior Sequence Transformer for E-commerce Recommendation in Alibaba",
DLP-KDD 2019, arXiv:1905.06874. The columns, shared spaces and streams are
DIN's and DIEN's; the model is ``models.sequence.BST`` with the paper's 8
heads, one block and its 1024-512-256 LeakyReLU tower. The paper gives the
embeddings' widths only as "4 ~ 64" and no FFN width: ``--emb_dim`` (32
here by default) is each of the item, category and position embeddings,
so the block is ``3 * emb_dim`` wide, and its FFN ``4 *`` that (Vaswani's
ratio). Adam at 0.001: the paper names no optimizer, and its learning
rate 0.01 diverges under Adam at these widths (the first step moves
each of ``fc_0``'s weights by 0.01 over a 9,728-wide input). Dropout is
``--dropout``, or the paper's ``DROPOUT`` without it. No ``--bf16``
policy.

Histories hold ``--max_len`` positions, or ``MAX_LEN`` (read when
:func:`build` runs) without it: 100, where Amazon Books' histories are cut
(the paper cut Taobao's at 20). The tower's input is the flattened
sequence, so the streams give every batch that many slots.
"""
import argparse

from ... import feature_column as fc
from ...config import Initializer
from ...models import sequence
from ...train import cli

MAX_LEN = 100
DROPOUT = 0.2
HEADS = 8
HIDDEN_UNITS = (1024, 512, 256)


def build(args) -> cli.ModelSpec:
    max_len = args.max_len or MAX_LEN
    dropout = DROPOUT if args.dropout is None else args.dropout
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
    model = sequence.BST(
        candidate_name="item", seq_name="hist_item", emb_dim=args.emb_dim,
        max_len=max_len, candidate_context_names=["cate"],
        seq_context_names=["hist_cate"], context_names=["uid"],
        heads=HEADS, hidden_units=HIDDEN_UNITS, dropout=dropout)
    return cli.ModelSpec(
        name="BST", model=model, numeric_columns=[],
        collections={"emb": coll},
        sparse_optimizers={"emb": cli.make_sparse_opt(args)},
        train_data=lambda a: cli.behavior_train_stream(_at_max_len(a)),
        eval_data=lambda a: cli.behavior_eval_stream(_at_max_len(a)))


def _at_max_len(args):
    """``args`` with the history length this entry builds at."""
    return argparse.Namespace(**{**vars(args),
                                 "max_len": args.max_len or MAX_LEN})


def parser():
    p = cli.base_parser("BST on behaviour data")
    p.set_defaults(optimizer="adam", learning_rate=0.001, emb_dim=32,
                   # behaviour sequences dedup poorly: most
                   # history ids are unique within a batch
                   max_unique_ratio=0.75)
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    cli.run(build(args), args)
