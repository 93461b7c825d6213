"""An int8 weight tree of each other decoder family served by the port
against the reference serving its own on the CPU (reduced configs):
``ServeEngine.generate`` on a 9-year device on the fused and three-pass
routes for rwkv6_3b (SSM) and paligemma_3b (VLM, with prefix
embeddings), the same greedy tokens
(:func:`torch_int8_common.assert_same_greedy`); the clean prefill logits
within :data:`torch_int8_common.LOGIT_ATOL`.  The MoE and hybrid families are
``test_torch_int8_families.py``'s."""
import pytest

from torch_int8_common import (check_clean_logits, check_generate_at_9y,
                               int8_pair)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)

FAMILIES = {"rwkv6_3b": {}, "paligemma_3b": {}}


@pytest.fixture(scope="module", params=list(FAMILIES))
def model(request):
    return int8_pair(request.param, **FAMILIES[request.param])


def test_clean_logits_match_reference(model):
    check_clean_logits(model)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
def test_generate_at_9y_matches_reference(model, fused):
    check_generate_at_9y(model, fused)
