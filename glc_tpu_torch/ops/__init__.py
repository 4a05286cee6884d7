"""Device-side math of the codec in PyTorch, plus the hand-written CUDA
IMDCT+window kernel (`kernels.imdct_window`)."""
