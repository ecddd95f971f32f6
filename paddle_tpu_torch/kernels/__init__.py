"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. The libraries build at first use (`_build`); importing this
package compiles nothing."""
