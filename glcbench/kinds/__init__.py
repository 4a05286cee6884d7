"""Traffic kinds: one generator and window driver a kind, found by the
traffic file's ``kind`` field."""
