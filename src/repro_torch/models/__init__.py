"""The model zoo's serving half: dense and vlm families (``model``,
``layers``); moe, encdec, hybrid and ssm raise until they are ported."""
