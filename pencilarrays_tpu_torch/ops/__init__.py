"""Local operations of the port: the permute kernel (K1), FFT plans,
reductions and grids."""
