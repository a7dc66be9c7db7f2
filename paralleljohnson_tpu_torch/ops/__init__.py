"""Device operations of the PyTorch port: plain relaxation primitives
(``relax``) and the hand CUDA kernels with their plain versions
(``fanout_sweep``, ``minplus``; built by ``_cuda``)."""
