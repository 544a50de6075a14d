"""The port's camera-DP step over 4 gloo ranks on the CPU, against the JAX
package's `make_train_step_dp` on `make_mesh(4, axis="dp")`: the case and
the holds of tests/test_torch_dist_dp.py (see its docstring), at the mesh
size that one leaves out.
"""
import pytest

from tests.test_torch_dist_dp import build_refs, check_replicas, check_step

CASES = [(4, "equal")]


@pytest.fixture(scope="module")
def refs():
    return build_refs((4,))


@pytest.mark.parametrize("n,case", CASES)
def test_dp_step_matches_jax(refs, n, case):
    check_step(refs, n, case)


@pytest.mark.parametrize("n,case", CASES)
def test_dp_replicas_bit_identical(refs, n, case):
    check_replicas(refs, n, case)
