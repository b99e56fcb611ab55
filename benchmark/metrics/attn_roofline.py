"""attn_roofline.*: the edge-softmax attention rows' least time a step
(``work()["attn_least_s"]``, ``harness/attn_roofline.py``) over the device
time of their kernels (``csrc/edge_attention.cu``: ``attn_light_kernel``,
``attn_hub_chunk_kernel``, ``attn_hub_finish_kernel``), in %."""
from harness import readers


def read(r):
    return readers.kernel_roofline(r, r"\battn_(light|hub_chunk|hub_finish)_kernel\b",
                                   "attn_least_s")
