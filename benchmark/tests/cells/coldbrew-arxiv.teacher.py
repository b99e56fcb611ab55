"""coldbrew-arxiv.teacher: its tiny sizes and planted faults."""
import torch

from cellparts import NODE, _frozen, _teacher_eval_alter

TINY = {"config": NODE, "traffic": {"epochs_per_call": 1}}


def _teacher_half(monkeypatch):
    from gnn_tail_generalization_tpu_torch.train import loops

    nll = loops._nll_masked

    def half(logits, y, mask, n_masked=None):
        rows = mask.nonzero()[:, 0]
        keep = torch.zeros_like(mask)
        keep[rows[: rows.numel() // 2]] = True
        return nll(logits, y, keep)
    monkeypatch.setattr(loops, "_nll_masked", half)


FAULTS = [_frozen, _teacher_half]
EVAL_FAULTS = [_teacher_eval_alter]
