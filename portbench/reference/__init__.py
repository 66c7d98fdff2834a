"""The plain references: ``flows.py`` (the layers, in plain PyTorch) and
one file a configuration, named after it, with the entries its cells'
drivers call. Nothing here imports the program under test."""
