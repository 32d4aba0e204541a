"""PyTorch/CUDA port of pde_policylearning_tpu.

The closed-loop channel-flow control path (env, policies, loop) runs on
plain torch on the CPU and through hand-written CUDA kernels on an
NVIDIA H100 (sm_90a); see `envs/rk3_cuda.py` and `csrc/`."""
