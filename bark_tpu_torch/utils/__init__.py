"""Host utilities of the PyTorch port: the WAV writer and reader
(`utils.wav`, a copy of bark_tpu's)."""
