"""The ctypes signatures of the port's kernel library against its C entries.

`kernels/_build.py` `_SIGNATURES` gives ctypes the argument types of each
`extern "C"` entry in `bark_tpu_torch/csrc/*.cu`. ctypes cannot see the
C side: an entry that gains a parameter its signature lacks still
loads, and the call passes the stream where the new parameter is read,
which fails only on the card (a segfault, or a launch on a wrong
stream). Here each signature is held to its entry's parameter count.
"""

import re

import pytest

from bark_tpu_torch.kernels import _build


def _entries() -> dict:
    """{entry name: its number of parameters} over csrc/*.cu."""
    entries = {}
    for path in sorted(_build.SRC_DIR.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(
                r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', text):
            entries[name] = len([p for p in params.split(",") if p.strip()])
    return entries


ENTRIES = _entries()


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_its_c_entry(name):
    assert name in ENTRIES, f"{name}: no extern \"C\" entry in csrc/*.cu"
    assert len(_build._SIGNATURES[name]) == ENTRIES[name]
