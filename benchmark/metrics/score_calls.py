"""score_calls.*: launches a step of the pair-scoring kernel (the port's
``score.kernel_calls`` counter): one a split an OGB evaluation scores with
the DOT predictor. Nothing where the program never counts them."""
from harness import spans


def read(r):
    rec = spans.recorded(r)
    if rec is None or "score.kernel_calls" not in rec["counters"]:
        return None
    return spans.counter(r, "score.kernel_calls")
