"""Host utilities of the PyTorch port: WAV I/O and timing meters."""
