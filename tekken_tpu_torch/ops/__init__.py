"""Device ops of the PyTorch port: boundary rules, stage 1, merge, and the
packed encode pipeline."""
