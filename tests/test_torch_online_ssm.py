"""The online engines on reduced rwkv6_3b (the SSM family's WKV states)
against the reference's: the cases of tests/test_torch_online_families.py,
which runs them on the hybrid."""
import pytest

from test_torch_online_families import (  # noqa: F401 (collected here)
    build, test_fleet_mid_decode_arrivals,
    test_one_device_mid_decode_arrivals)
from torch_test_common import _one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model():
    return build("rwkv6_3b")
