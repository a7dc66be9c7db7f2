"""The yardstick, frozen: copies of the program's cost model and the
card's published peaks, so that a later change to the program cannot
move what its kernels are measured against."""
