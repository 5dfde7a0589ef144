"""Runtime sanitizers for the device plane (``REPRO_SANITIZE=1``).

Counterpart of the policy part of ``repro.analysis.sanitize``: the flag
that turns the checks on and the failure type they raise.  The checks
themselves live in ``dataflow/device.py``
(:meth:`~repro_torch.dataflow.device.DeviceOpRuntime._sanitize_check`),
run at every ``sync_host`` boundary:

* **mirror cross-check** (``sanitize-mirror`` / ``sanitize-spill``) --
  the exact host mirrors against the device truth (ring ``tail - head``
  against the resident count ``lens - spilled_lens``, ``rlen`` against
  ``rows_len - spilled_rows``), and the spill tier's host segments
  re-counted against the ``spilled_lens`` / ``spilled_rows`` mirrors;
* **fold guards** (``sanitize-nan``) -- fold-state sums scanned for NaN
  and inf.

The JAX package's third sanitizer, the retrace sentinel, counts the
compilations of each jitted step.  The port traces nothing (its resident
dispatch runs eagerly), so it has no counterpart here.
"""
from __future__ import annotations

import os

__all__ = ["SanitizeError", "enabled"]


class SanitizeError(AssertionError):
    """A device-plane invariant failed under REPRO_SANITIZE=1."""


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")
