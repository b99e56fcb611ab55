"""i2gtl-citation2-transformer.train: its tiny sizes and planted faults."""
import importlib.util
from pathlib import Path

import torch

from cellparts import LINK, _frozen

#: the tiny run's own limits: at this size the TF32 control moves the change
#: norms about twenty times less than at the cell's (its median gap 1.4e-5
#: here, 3.6e-4 and more there), under the cell's limits, which hold the
#: cell's size's rounding; the program reads at most 2.9e-6 and 3.4e-7 here
TINY = {"config": LINK, "traffic": {"steps_per_slice": 1, "limits": {
    "loss_gap": 6e-07, "change_gap": 1.5e-05, "median_gap": 2e-06}}}


def _sage_cell():
    """The SAGE train cell's file, whose half-batch fault this cell shares."""
    path = Path(__file__).with_name("i2gtl-citation2-sage.train.py")
    mod_spec = importlib.util.spec_from_file_location("sage_train_cell_faults", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


_link_half = _sage_cell()._link_half


def _uniform_attention(monkeypatch):
    """The attention weights of a row all equal (1 / in-degree), in the
    forward and in the backward that reads them."""
    from gnn_tail_generalization_tpu_torch.graph.core import edge_rows
    from gnn_tail_generalization_tpu_torch.ops import edge_attention as ea

    rows_fn = ea.edge_attn_rows

    def uniform(mode, indptr, indices, a, b, scale, alpha=None, schedule=None):
        if mode != "softmax":
            return rows_fn(mode, indptr, indices, a, b, scale, alpha, schedule)
        deg = (indptr[1:] - indptr[:-1]).float()
        return (1.0 / deg)[edge_rows(indptr, indices.numel())]
    monkeypatch.setattr(ea, "edge_attn_rows", uniform)


def _attention_grad_without_mean(monkeypatch):
    """The logits' gradient without its row term: ``alpha_e dp_e`` times the
    scale, where it is ``alpha_e (dp_e - D_r)``."""
    from gnn_tail_generalization_tpu_torch.graph.core import edge_rows
    from gnn_tail_generalization_tpu_torch.ops import edge_attention as ea

    rows_fn = ea.edge_attn_rows

    def without_mean(mode, indptr, indices, a, b, scale, alpha=None, schedule=None):
        if mode != "grad":
            return rows_fn(mode, indptr, indices, a, b, scale, alpha, schedule)
        rows = edge_rows(indptr, indices.numel())
        return alpha * torch.sum(a[rows] * b[indices.long()], dim=-1) * scale
    monkeypatch.setattr(ea, "edge_attn_rows", without_mean)


FAULTS = [_frozen, _link_half, _uniform_attention, _attention_grad_without_mean]
