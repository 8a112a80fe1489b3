"""Host sketch twins (numpy). Only the spread family's part is ported."""
