"""The plain reference that decides ``correct``: plain PyTorch and NumPy, nothing of the port."""
