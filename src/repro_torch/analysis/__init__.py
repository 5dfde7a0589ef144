"""Runtime checks of the device plane's invariants (``sanitize``)."""
