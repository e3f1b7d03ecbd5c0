"""``detr_tpu_torch.entry.entry()`` against the repository's
``__graft_entry__.entry()``: the same DETR-R50 (the default ``DETRConfig``,
bf16 compute) on the same weights (the JAX entry's init, carried by
``state_dict_from_jax``) and the same 640x640 example image, on the CPU.

Both compute in bf16 with fp32 sums in other orders, through a random
ResNet-50 trunk with identity frozen-BN statistics: the logits agree to
2e-2 of their largest magnitude (measured: 0.98 %), the boxes to 1e-3
(measured: 5.3e-5).  A weight in the wrong place moves them by their own
size.
"""

import jax
import numpy as np

import __graft_entry__ as graft
from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.models import DETR as JaxDETR
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.entry import entry
from detr_tpu_torch.models import state_dict_from_jax
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)


def test_entry_forward_matches_the_jax_entry():
    fn, args = graft.entry()
    want = jax.jit(fn)(*args)
    # the JAX entry's weights: its init, jitted, from the same key and inputs
    variables = jax.jit(JaxDETR(JaxConfig()).init)(jax.random.PRNGKey(0), *args)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]),
                             jax.tree.map(np.asarray, variables["frozen"]), DETRConfig())
    port_fn, port_args = entry(device="cpu", state_dict=sd)
    for got, ref in zip(port_args, args):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    out = port_fn(*port_args)
    assert not out["pred_logits"].requires_grad
    for key, rel in (("pred_logits", 2e-2), ("pred_boxes", None)):
        w = np.asarray(want[key], np.float32)
        o = out[key].float().numpy()
        assert o.shape == w.shape and np.isfinite(o).all()
        atol = 1e-3 if rel is None else rel * float(np.abs(w).max())
        np.testing.assert_allclose(o, w, rtol=0, atol=atol, err_msg=key)
