"""i2gtl-citation2-sage.train: its tiny sizes and planted faults."""
from cellparts import LINK, _frozen

TINY = {"config": LINK, "traffic": {"steps_per_slice": 1}}


def _link_half(monkeypatch):
    from gnn_tail_generalization_tpu_torch.linkpred import model as lpm

    loss = lpm.compute_loss

    def half(cfg, pos_out, neg_out, margin=None, valid=None):
        n = pos_out.shape[0] // 2
        return loss(cfg, pos_out[:n], neg_out[: n * cfg.num_neg], margin, valid[:n])
    monkeypatch.setattr(lpm, "compute_loss", half)


FAULTS = [_frozen, _link_half]
