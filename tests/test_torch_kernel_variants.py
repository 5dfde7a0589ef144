"""``kernel_variants.py``'s tables of source edits against the sources.

Each variant is the source under ``src/repro_torch/kernels/csrc/`` with a
few texts replaced; the script refuses a variant one of whose texts is
not in the source exactly once.  Applied here to the sources as they are
(no nvcc needed), so an edit of a source that leaves a table behind fails
at once and not on the card.
"""
import importlib.util
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]


def _kernel_variants():
    """``kernel_variants.py`` as a module (it imports nothing at the top
    but the standard library)."""
    mod = sys.modules.get("kernel_variants")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "kernel_variants", ROOT / "kernel_variants.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["kernel_variants"] = mod
    return mod


kv = _kernel_variants()
CASES = [pytest.param(source, table[name], id=f"{source}: {name}")
         for source, table in kv.TABLES for name in table]


def test_every_table_is_registered():
    tables = {name for name, value in vars(kv).items()
              if isinstance(value, dict) and value
              and all(isinstance(e, dict) for e in value.values())}
    registered = {name for name, value in vars(kv).items()
                  if any(value is t for _, t in kv.TABLES)}
    assert tables == registered


@pytest.mark.parametrize("source, edits", CASES)
def test_each_edit_is_once_in_its_source(source, edits):
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = kv.apply_edits(src, edits, source)
    assert (out == src) == (not edits)


def test_apply_edits_refuses_a_missing_or_repeated_text():
    with pytest.raises(RuntimeError, match="not once"):
        kv.apply_edits("a b", {"c": "d"}, "missing")
    with pytest.raises(RuntimeError, match="not once"):
        kv.apply_edits("a a", {"a": "d"}, "repeated")
    assert kv.apply_edits("a b", {"a": "c", "c b": "e"}) == "e"
