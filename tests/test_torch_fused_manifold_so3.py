"""tests/test_torch_fused_manifold.py's parity with the JAX package's
fused kernel (interpret mode, float64, per instance) on phase 22's
residuals over SO3, SE23 and SEn3 leaves: one batched SO3 leaf of 4
rotations (an anchor prior and a cycle of relative rotations), and
(prior⁻¹ @ X).log() on SE23 and on SEn3 (n = 2)."""

import pytest
import torch

import torch_manifold_cases as cases
from test_torch_fused_manifold import B, SEEDS, assert_parity, check_family

torch.set_num_threads(1)

NAMES = ("so3_cycle", "se23_prior", "sen3_prior")


@pytest.fixture(scope="module")
def solved():
    """Each case solved once by the JAX kernel and by the port."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = cases.solve_both(name, B, SEEDS[name])
        return cache[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_port_fused_matches_jax_kernel(name, solved):
    """The port's fused path against the JAX kernel per instance."""
    ref, got, *_ = solved(name)
    assert_parity(ref, got)


@pytest.mark.parametrize("name", NAMES)
def test_generated_family_of_each_case(name, solved):
    """The case's generated family and K2 plan."""
    _, _, tx, td, topts = solved(name)
    check_family(name, tx, td, topts)
