"""i2gtl-citation2-sage.eval: its tiny sizes and planted faults."""
from cellparts import LINK

TINY = {"config": LINK}


def _eval_half(monkeypatch):
    from gnn_tail_generalization_tpu_torch.linkpred import metrics

    mrr = metrics.mrr

    def half(pos, neg):
        n = pos.shape[0] // 2
        return mrr(pos[:n], neg[:n])
    monkeypatch.setattr(metrics, "mrr", half)


def _eval_score_alter(monkeypatch):
    from gnn_tail_generalization_tpu_torch.linkpred.predictors import DotPredictor

    forward = DotPredictor.forward

    def altered(self, x_i, x_j, *, generator=None):
        out = forward(self, x_i, x_j, generator=generator).clone()
        out[::2] -= 1.0
        return out
    monkeypatch.setattr(DotPredictor, "forward", altered)


FAULTS = [_eval_half, _eval_score_alter]
