"""mmtpu_torch — the PyTorch/CUDA port of mmtpu for NVIDIA Hopper (H100).

A second package beside `mmtpu/` (the JAX reference, left unchanged). It
keeps mmtpu's module layout and names so each counterpart is easy to find,
its public functions keep mmtpu's layouts (NHWC numpy batches, the same
batch schema, config files and output JSON), and it imports nothing of JAX
or of `mmtpu`: where it needs a JAX-free host module it keeps its own copy.

Ported so far: serving and training of the AVMNIST late-fusion model (the
paper's pipeline: monomodal pretraining, the encoder handoff, the
fine-tune; ResNet and LeNet encoders; the real AVMNIST reader and the
synthetic stand-in; cross-validation and sequential --stacked-runs) and of
MOSI UttFusion; C-MAM (CMAM and DualCMAM against either as a frozen
teacher); TensorBoard, the run log and the reports; data parallelism over
several GPUs (`mmtpu_torch.parallel`); both of mmtpu's TPU kernels as
hand-written CUDA kernels (`mmtpu_torch.ops`). ROADMAP.md lists what is
not.

Entry points run on `cuda` unless the caller asks for the CPU (`--cpu`,
`device="cpu"`); without a GPU they raise instead of falling back.
"""
