"""Host-side data helpers of the port (the dialog templates, so far)."""
