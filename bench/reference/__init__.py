"""Plain PyTorch and NumPy references of what the benchmark's cells run.
They import nothing of the program (``repro_torch``) and read only the
inputs the benchmark made and the outputs the program produced."""
