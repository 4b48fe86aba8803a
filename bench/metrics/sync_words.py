"""``sync_words`` (words, layer: GradSync): the words a rank sends in a
step, the program's counters ``sync/sparse_sent_words`` +
``sync/dense_words`` of the last traced step.  On one card it is a count:
it costs time only where the collectives cross a link.  Moves
``train_tokens_per_s``."""
UNIT = "words"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    return rec.get("sync_words")
