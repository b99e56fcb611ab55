"""What the cells' test files (``cells/<cell>.py``) share: the tiny sizes of
the two configurations and the faults that more than one cell plants. A
fault is a function of pytest's ``monkeypatch`` that breaks the timed path
underneath; its name is part of its test's id."""
import torch

LINK = {"dataset": {"n_node": 5000, "n_raw_edge": 40000, "n_valid": 200, "n_test": 200},
        "model": {"batch_size": 1024}}
NODE = {"dataset": {"n_node": 9000, "n_raw_edge": 40000}}


def _frozen(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _alter_rows(logits):
    """Every other row's logits rolled by one class."""
    logits = logits.clone()
    logits[::2] = logits[::2].roll(1, dims=1)
    return logits


def _teacher_eval_alter(monkeypatch):
    from gnn_tail_generalization_tpu_torch.models.teacher import TeacherGNN

    forward = TeacherGNN.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return out if self.training else (out[0], _alter_rows(out[1]), *out[2:])
    monkeypatch.setattr(TeacherGNN, "forward", altered)
