"""coldbrew-arxiv.student: its tiny sizes and planted faults."""
import torch

from cellparts import NODE, _alter_rows, _frozen

TINY = {"config": {**NODE, "student": {"batch_size": 1024}}, "traffic": {"epochs_per_call": 1}}


class _HalfCE:
    """``torch.nn.functional`` whose cross-entropy takes the first half of
    the rows alone."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def cross_entropy(logits, y):
        n = logits.shape[0] // 2
        return torch.nn.functional.cross_entropy(logits[:n], y[:n])


def _student_half(monkeypatch):
    from gnn_tail_generalization_tpu_torch.train import loops

    monkeypatch.setattr(loops, "F", _HalfCE())


def _student_eval_alter(monkeypatch):
    from gnn_tail_generalization_tpu_torch.models.semlp import SEMLPPart2

    forward = SEMLPPart2.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return out if self.training else _alter_rows(out)
    monkeypatch.setattr(SEMLPPart2, "forward", altered)


FAULTS = [_frozen, _student_half]
EVAL_FAULTS = [_student_eval_alter]
