"""One full-parameter train step of the recurrent and encoder-decoder
layouts against the reference's jnp-backend step, from bridged weights on
the CPU: rwkv6-1.6b (its forward runs every layer from a zero state),
recurrentgemma-2b (the RG-LRU hybrid, attention layers in its window) and
seamless-m4t-large-v2 (the encoder-decoder, ``batch["frames"]``). The loss
and ``grad_norm`` within 1e-5 relative, every updated leaf and moment
within 1e-4 of the leaf's largest magnitude (``test_torch_train``'s
``check_step``).
"""

import pytest

from test_torch_train import check_step, train_pair


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_train_step_of_each_layout_matches_the_reference(arch):
    ref_out, port_out, _ = train_pair(arch, frames=arch == "seamless-m4t-large-v2")
    check_step(ref_out, port_out)
