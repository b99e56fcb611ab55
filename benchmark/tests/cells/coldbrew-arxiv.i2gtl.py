"""coldbrew-arxiv.i2gtl: its tiny sizes and planted faults."""
from cellparts import NODE, _frozen, _teacher_eval_alter

TINY = {"config": NODE, "traffic": {"epochs_per_call": 1}}


def _pairs_half(monkeypatch):
    """The edgewise loss and MRR over the first half of the positives and
    of the negatives alone."""
    from gnn_tail_generalization_tpu_torch.train import edgewise

    loss_eva = edgewise.linkp_loss_eva

    def half(pos, neg):
        return loss_eva(pos[: pos.shape[0] // 2], neg[: neg.shape[0] // 2])
    monkeypatch.setattr(edgewise, "linkp_loss_eva", half)


def _pairs_score_alter(monkeypatch):
    """Every other test positive's score lowered by 1 where it is produced."""
    from gnn_tail_generalization_tpu_torch.train import edgewise

    loss_eva = edgewise.linkp_loss_eva

    def altered(pos, neg):
        if not pos.requires_grad:
            pos = pos.clone()
            pos[::2] -= 1.0
        return loss_eva(pos, neg)
    monkeypatch.setattr(edgewise, "linkp_loss_eva", altered)


FAULTS = [_frozen, _pairs_half, _pairs_score_alter]
EVAL_FAULTS = [_teacher_eval_alter]
