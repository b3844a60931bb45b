"""Architecture and shape configurations of the model zoo (own copy of
``repro/configs``; ``get_config(name)`` looks an arch up by name)."""
