"""mmtpu_torch — the PyTorch/CUDA port of mmtpu for NVIDIA Hopper (H100).

A second package beside `mmtpu/` (the JAX reference, left unchanged). It
keeps mmtpu's module layout and names so each counterpart is easy to find,
its public functions keep mmtpu's layouts (NHWC numpy batches, the same
batch schema, config files and output JSON), and it imports nothing of JAX
or of `mmtpu`: where it needs a JAX-free host module it keeps its own copy.

Ported so far: the AVMNIST late-fusion serving path — config loading,
synthetic AVMNIST data and the fixed-shape loader, the ResNet encoders and
the AVMNIST model, the fused-MLP fusion head as a hand-written CUDA kernel
(`mmtpu_torch.ops`), the eval step, the in-process predictor, the
micro-batcher, and the `predict` / `serve` entry points.

Entry points run on `cuda` unless the caller asks for the CPU (`--cpu`,
`device="cpu"`); without a GPU they raise instead of falling back.
"""
