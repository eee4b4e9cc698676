"""Policy network, WDGAIL critic and their input processors."""
