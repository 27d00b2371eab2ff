"""F1's wide mode in numpy (the model of ``test_torch_f1_wide_design.py``)
at eight warps a block — several passes per group — against the plain
wide steps, on every ``CASES`` entry.
"""

import pytest

from test_torch_f1_wide_design import CASES, design_equals_plain


@pytest.mark.parametrize("warps", [8])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wide_design_equals_plain(case, warps):
    design_equals_plain(case, warps)
