"""Pure-Python helpers of the PyTorch port."""
