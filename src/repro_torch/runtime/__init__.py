"""Host-side runtime controllers: the error-budget loop."""
