"""The bounds chip_smoke.py holds the card to, checked where they are derived
rather than measured. ``h_inverse_step`` is the float32 resolution of h^-1
(``ops/scaling.py:_h_inverse``) at a value: a learn step's priority on the
card may differ from the CPU's by that step beyond VALUE_TOL x the value.
Here it must equal the largest jump of the port's float32 h^-1 between
neighbouring float32 inputs around the transformed value, to within the
rounding of h^-1's last product, u^2 = |v| + 1: two float32 steps of it."""
import pytest
import torch

import chip_smoke
from lightzero_tpu_torch.ops.scaling import _h_inverse, scalar_transform

pytestmark = pytest.mark.unittest


@pytest.mark.parametrize("value", [0.0, 0.065, 1.0, 10.0, 100.0, 1000.0])
def test_h_inverse_step_is_the_float32_resolution_of_h_inverse(value):
    x = float(scalar_transform(torch.tensor(value, dtype=torch.float64)))
    # inputs 1e-8 apart, finer than the square root's argument resolves
    # (its float32 step, 1.2e-7 or more, is 3e-5 or more of x)
    grid = torch.linspace(x - 2e-4, x + 2e-4, 40001, dtype=torch.float32)
    jumps = (_h_inverse(grid)[1:] - _h_inverse(grid)[:-1]).abs()
    expected = float(chip_smoke.h_inverse_step(torch.tensor([value]))[0])
    u2 = torch.tensor(value + 1.0, dtype=torch.float32)
    rounding = 2 * float(torch.nextafter(u2, torch.tensor(float("inf"))) - u2)
    assert abs(float(jumps.max()) - expected) <= rounding
