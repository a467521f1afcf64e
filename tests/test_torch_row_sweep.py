"""``tools/row_sweep.py`` on the CPU: every design variant of the row
kernels 1 and 13 still applies to the committed sources (its text
substitutions find their text) and keeps the C entry the sweep calls.
Building and timing the variants needs the card."""

import pytest

from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.tools import row_sweep

VARIANTS = row_sweep.variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_applies_to_the_committed_source(name):
    lib, src = VARIANTS[name]
    base = (_build.CSRC / f"{lib}.cu").read_text()
    assert (src == base) == name.endswith(".kernel")
    assert f'extern "C" int pbx_{lib}(' in src


def test_emit_writes_every_variant(tmp_path):
    paths = row_sweep.emit(str(tmp_path))
    assert sorted(paths) == sorted(VARIANTS)
    for name, path in paths.items():
        assert open(path).read() == VARIANTS[name][1]
