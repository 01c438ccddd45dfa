"""The benchmark's plain reference: the float32 PyTorch building blocks
(``blocks.py``) that each architecture's forward pass
(``benchmark/arch/<name>.py``) is written from, after the models'
published descriptions and independent of the served program (nothing
here imports it)."""
