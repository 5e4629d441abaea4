"""The JAX package's allocator tests (tests/test_allocator.py) run
unchanged on the port's manager/allocator.py: network subnets, the
cluster's ingress port space (published and dynamic ports, per protocol,
released and reused), host-mode ports kept out of that space, VIPs and
task attachments."""

from __future__ import annotations

import pytest

from tests.torch_port_copies import cases, port_copy

ALLOCATOR_CASES = port_copy("test_allocator")


@pytest.mark.parametrize("case", cases(ALLOCATOR_CASES))
def test_jax_allocator_case_on_port(case):
    getattr(ALLOCATOR_CASES, case)()
