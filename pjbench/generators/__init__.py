"""Graph generators, one module per kind. A configuration names its kind
(``"generator"``); :func:`pjbench.manifest.generator` imports
``generators/<kind>.py`` and calls its ``build(config, seed, device)`` with the configuration's
file,
which returns the host CSR arrays ``{"indptr", "indices", "weights"}``
(int32, int32, float32), the form the program's API takes."""
