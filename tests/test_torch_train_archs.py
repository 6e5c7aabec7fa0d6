"""One full-parameter train step of the other dense and MoE layouts
against the reference's jnp-backend step, from bridged weights on the CPU:
gemma-2b (MQA, GeGLU) and deepseek-v2-lite-16b (MLA and the MoE FFN, so
the step's loss carries the auxiliary load-balancing term). The loss and
``grad_norm`` within 1e-5 relative, every updated leaf and moment within
1e-4 of the leaf's largest magnitude (``test_torch_train``'s
``check_step``). The recurrent and encoder-decoder layouts are in
``test_torch_train_layouts.py``.
"""

import pytest

from test_torch_train import check_step, train_pair


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b"])
def test_train_step_of_each_layout_matches_the_reference(arch):
    ref_out, port_out, _ = train_pair(arch)
    check_step(ref_out, port_out)
