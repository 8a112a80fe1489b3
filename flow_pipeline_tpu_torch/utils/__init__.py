"""Host utilities (the dotted-flag parser)."""
