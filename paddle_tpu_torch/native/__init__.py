"""The port's host C++ runtime pieces (`tcp_store.cc`, `shm_ring.cc`),
copies of the JAX package's `native/` sources, built by `_build`."""
