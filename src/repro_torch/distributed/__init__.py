"""Host-side pieces of the reference's ``repro.distributed`` that the
single-host runner needs (the multi-device program is not ported)."""
