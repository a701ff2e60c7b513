"""chip_smoke.py's rule for a whole profile (`profile_whole`), on the CPU:
a profile is taken as whole when an earlier profile of the same run agrees
with it within 1%, whichever earlier profile that is, so profiles whose
counts alternate still give one; a profile that kept nothing never does."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def first_whole(counts, partial=False):
    """The index of the first profile taken as whole, or None."""
    rule = smoke().profile_whole
    for i, seen in enumerate(counts):
        if rule(seen, counts[:i], partial):
            return i
    return None


@pytest.mark.parametrize("counts,partial,want", [
    ([918, 918], False, 1),  # two agreeing profiles
    ([913, 918], False, 1),  # within 1%
    ([913, 968, 913, 968], False, 2),  # alternating counts: the third agrees with the first
    ([913, 968, 968], False, 2),
    ([0, 913, 0, 913], False, 3),  # empty profiles agree with nothing
    ([500, 913, 700, 300, 820, 100], False, None),  # every profile lost a different part
    ([0, 0, 0], True, None),
    ([0, 13, 20], True, 1),  # partial: any profile that kept a launch
])
def test_profile_whole_takes_any_earlier_agreeing_profile(counts, partial, want):
    assert first_whole(counts, partial) == want
