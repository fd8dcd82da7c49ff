#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`mmtpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's serving paths at the full width of two models, from seeded
random weights: the AVMNIST late-fusion model (ResNet18 audio encoder,
hidden 64; ResNet34 image encoder, hidden 128; head 192→128→64→10) and the
MOSI UttFusion model at its published widths (LSTM 5→64 audio, LSTM 20→64
video, pooling 'last'; TextCNN 768→64 with 128 channels, heights 3/4/5;
FcClassifier 192→[192, 64, 32]→3; batch 32, aligned T = 50):

1. build   — compiles every kernel from `mmtpu_torch/ops/csrc`, one nvcc per
             source, all started together;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the paths give it (the MLP also with a misaligned
             weight view and with a chain too wide to stay in shared
             memory), with timings (CUDA events per call, the host's wall
             time per launch, profiler device time); the LSTM also against
             `torch.nn.LSTM` as the library's call, and its gradient against
             autograd through the plain scan. The LSTM is timed at the main
             shape, at H >= 256 and at the ranks' shards (every shape is held
             against the plain scan, with the design that runs it: narrow,
             cluster or grid), and at the crossover shapes on every design
             that takes them, in turns. Every profiled window records the
             device activity alone (not the ATen operators);
3. predict — the `predict` entry over a synthetic test split, once per
             model (AVMNIST: 1000 samples × ai/a/i, batch 128; UttFusion:
             686 samples × 7 patterns = 4802 visits, batch 32); logits
             checked against the port on the CPU; the model's kernel must be
             launched exactly once per batch;
4. serve   — the HTTP server in process, once per model: concurrent /predict
             requests (some with a modality zeroed) and one /predict_batch,
             each answer checked against the Predictor; a request that
             lacks an input key must get 400; the same requests against a
             server with no model give the host's ceiling;
5. train   — the AVMNIST pretrain-then-fine-tune pipeline through the
             training entry points' `main` on the card, at the widths of
             configs/avmnist/synthetic_mono_audio.yaml and
             synthetic_multimodal_pretrained.yaml (2048 train samples, 512
             validation and 512 test, batch 128, 2 epochs): `train_monomodal`
             writes the audio handoff, `train_multimodal` fine-tunes from it
             (its audio encoder at epoch 0 must be the handoff's, and
             `fused_mlp` must run once per fused eval step of the
             device-resident path, 1536 rows in 1024-row steps, and in no
             train forward), and again from scratch; then a profiled
             window of train steps, and the first three train steps (and one
             with a padded tail) on the card against the CPU;
6. train utt — MOSI UttFusion training through `train_multimodal.main` at
             the published widths on synthetic_mosi at CMU-MOSI's split
             sizes (1284 train, 229 validation, 686 test; T = 50, batch 32,
             2 epochs, train pattern `atv` with audio and video missing at
             0.2, evaluation over the seven patterns): `lstm` must launch
             once per train batch and fused eval step (256 rows); the MSA keys of
             test_metrics.json; a profiled window of 8 train steps
             (launches per step, busy share); the first three train steps
             (where `clip` scales the gradients) and the epoch's padded
             tail on the card against the CPU.

7. reader  — the paper's own fine-tune configs (plain-dict twins of
             configs/avmnist/multimodal_resnet_{pretrained,scratch}.yaml:
             ResNet18/ResNet34 at full width, the files' optimizer groups,
             scheduler and metrics, batch 128) fed by the real AVMNIST
             reader from `.pt` files this run writes (2048/512/512
             samples): the arrays checked byte for byte and timed from the
             files and from the `.npy` sidecars; `train_avmnist` on the
             pretrained twin from phase 5's audio handoff, 2 epochs, with
             `--profile` and TensorBoard (the trace and the tfevents file
             must be written; `fused_mlp` exactly 6 launches: 2 fused eval
             steps per validation and test pass); the scratch twin as a
             two-fold cross-validation (`fold_1/`, `fold_2/`, the three
             `*_metrics_agg.json`; 12 launches) and as a `--stacked-runs 2`
             sweep at 512/128/128 samples through the stacked engine (runs 1
             and 2, seeds 42 and 43; one launch per stacked eval step: 9).

8. shipped — the shipped-weights flow (plain-dict twins of
             configs/avmnist/shipped_wheights_{finetune,finetune_audiofix,
             scratch}.yaml: MNISTAudio and MNISTImage, 32/64 channels,
             hidden 64; head 128→128→64→10, dropout 0.5; the files' Adam
             groups and plateau scheduler; batch 128) on phase 7's `.pt`
             files: a reference-layout image-encoder `.pth` written from the
             seed (30 tensors, wrapped in `model_state_dict` with a
             `module.` prefix) loads byte for byte and replays the reference
             module within 1e-4 on the card; `train_multimodal.main` runs
             the three twins for 2 epochs (the image encoder at epoch 0 the
             file's in two of them; the audiofix groups at 5e-4 / 1e-4;
             `fused_mlp` exactly 6 launches each; mmtpu's test keys);
             predict on the fine-tune's best.pth against the CPU; a
             profiled window of 8 fine-tune train steps; three
             train steps with each of rmsprop (with and without momentum),
             adagrad, adadelta, adamax, asgd and sparse_adam on the card
             against the CPU, and lbfgs raising on both. The kernels phase
             also holds `fused_mlp` at the head's dims [128, 128, 64, 10].

9. cmam    — C-MAM through `train_cmam.main`, both kinds at full width:
             a twin of configs/avmnist/cmam_audio_to_image.yaml (ResNet18
             student, hidden 64, AssociationNetwork 64→256→128 with
             BatchNorm and dropout 0.25, against phase 5's scratch
             fine-tune restored from its best.pth, on phase 7's `.pt` files,
             2048/512/512 samples, batch 128, 2 epochs) and of
             configs/mosi/synthetic_dual_cmam.yaml at the published
             UttFusion widths (LSTM 5→64 student, decoders 64→64→64,
             against phase 6's model; 1284/229/686 samples, T = 50, batch
             32, 2 epochs): the teacher's state hash equal to its file's
             before the run and after it, `fused_mlp` never launched,
             `lstm` three times per DualCMAM batch, mmtpu's record keys
             (the nested groups, loss, the term columns); a profiled window
             of 8 train steps and the first three steps and a padded-tail
             step on the card against the CPU, for each kind.

10. msa    — MMIN and RedCore through `train_multimodal.main` at full width on
             synthetic_mosi at CMU-MOSI's split sizes (1284/229/686, T = 50,
             batch 32, 2 epochs, train `atv` with audio and video missing at
             0.2, evaluation over `atv`, `at`, `tv`): a twin of
             configs/mosi/synthetic_mmin_teacher.yaml (the student at the
             published UttFusion widths, AE 256,128,64 in 5 blocks,
             classifier 320→[128,128]→3) over phase 6's model as its frozen
             teacher, restored from its best.pth: the teacher's state hash
             equal to its file's before the run and after it, `lstm` exactly
             3 per train batch and 1 per evaluation batch (355), `fused_mlp`
             never; and a RedCore twin (Transformer encoders, embedding 64;
             the MMIN twin's AE; ResidualXE generators 128→64) launching
             neither kernel; for each, a profiled window of 8 train steps and
             the first three steps and the padded tail on the card against
             the CPU (RedCore's dropouts and VAE sample neutralised, its β
             and η after three steps compared).

11. self-mm, mmimdb — (a) Self-MM through `train_multimodal.main` at the
             widths of MMSA's config_regression.json for self_mm on mosi
             (BERT-base text, AuViSubNet audio 5→16 and video 20→32, post
             dims 128/32/16/32) on synthetic_mosi in `text_mode: bert` at
             1284/229/686, T = 50, batch 32, 2 epochs: twice, with the
             fresh BERT frozen and fine-tuned from an HF-style directory
             this run writes from the seed (`config.json`,
             `pytorch_model.bin`); `lstm` exactly 2 per train, validation
             and test batch (240), `fused_mlp` never; the banks finite on
             the card after the run, the unimodal labels within ±3; the
             checkpoints' size; a profiled window of 8 epoch-2 train steps;
             the first three steps, the padded tail and one epoch-2 step
             (the label refinement) on the card against the CPU, gradients
             of BERT included when it fine-tunes. (b) MM-IMDb at the
             published GMU widths (configs/mmimdb/synthetic_gmu.yaml: 4096
             and 300 features, 512 hidden, 23 genres) at MM-IMDb's split
             sizes 15,552/2,608/7,799, batch 64, 2 epochs, evaluation over
             `it`, `i`, `t`: no launch of either kernel, mmtpu's F1 keys;
             predict on the best checkpoint against the CPU; the server's
             multilabel answers and a 400 for a request without `text`; a
             profiled window; the first three steps and a padded tail GPU
             vs CPU (gradients in float64). Phase 2 also holds `lstm` at
             Self-MM's two shapes, G=1 B=32 T=50 H=16 and H=32.

12. export, kinetics-sounds, mono — (a) the serving export on the card:
             phase 5's scratch fine-tune through `predict --export` on phase
             3's 1000-sample split, its artifact over the 3000 visits at
             B=128 (`fused_mlp` exactly once per batch inside it: 24), and
             phase 6's UttFusion model the same way over 4802 visits at B=32
             (`lstm` 151); every output within 1e-5 of the Predictor (TF32
             off), visits/s of both; the AVMNIST artifact loaded on the CPU
             within 1e-3 of the card; `serve --artifact` on it, 48 requests
             from 16 clients against the Predictor; phase 9's DualCMAM twin
             through `train_cmam --export-serving` (1 epoch), its artifact
             within 1e-5 of the C-MAM serving function on the best
             checkpoint, `lstm` exactly 2 per batch inside it. (b)
             Kinetics-Sounds through `train_multimodal.main` on the
             repository's 468/156/156 clips (CSVs written over this
             checkout's tensors), mmtpu's class defaults with ConvBlocks
             1→16→32→64 (the flatten exactly 512), batch 64, Adam 1e-3, 2
             epochs, `av`/`a`/`v` evaluation: no launch of either kernel; a
             profiled window of 8 train steps; steps 1-3 and the padded tail
             (20 real rows of 64) GPU vs CPU, step-1 gradients in float64;
             `predict --export` over 156 × 3 visits, the artifact against
             the Predictor, the server. (c) `train_monomodal` for TextCNN
             768→64 (128 channels), LSTMEncoder 5→64 (`lstm` once per train,
             validation and test batch) and MMIMDbModalityEncoder 300→512,
             2 epochs each; the UttFusion and GMU fine-tunes (1 epoch) load
             their handoffs, each encoder's sha256 equal to its file's.
             Phase 2 also times both kernels' host cost per launch through
             their `torch.library` operators and through `_launch` alone.

13. iemocap, mmimdb chain, recurrent — (a) IEMOCAP's 10-fold CV through
             `train_multimodal.main` at the widths of MMIN's IEMOCAP UttFusion
             (comparE 130 → LSTM 128 and denseface 342 → LSTM 128, maxpool;
             bert_large 1024 → TextCNN 128; FcClassifier 384 → [128, 128] → 4,
             dropout 0.3), batch 128, Adam 1e-3, 2 epochs per fold, train
             `atv`, evaluation over the seven patterns, on the repo's fold
             files (DATA/iemocap/target/1..10: 1024/256/256 per fold) with
             seeded features fed to the reader's assembling step (the card's
             machine has no h5py): `lstm` launches equal to the count derived
             beforehand from the padded lengths the reader gives (one launch
             per forward where audio and video share T, else two), the
             three `*_metrics_agg.json`, a profiled window of 8 train steps,
             three train steps GPU vs CPU. (b) MM-IMDb: phase 12 (c)'s text
             pretraining, a fine-tune of configs/mmimdb_pretrained_text_only
             .yaml's model and optimizers at its published widths on
             `synthetic_mmimdb` at 15,552/2,608/7,799 (batch 128, 1 epoch),
             then C-MAM image → text over it with `--export-serving` (1
             epoch): the loaded text encoder's and the teacher's sha256 equal
             to their files', no launch of either kernel, the C-MAM record
             keys equal tests/golden/reference_cmam's, the artifact within
             1e-5 of the eager C-MAM serving function. (c) the recurrent
             registry encoders (VariationalLSTMEncoder, VariationalLSTMEncoder2
             with attention, SeqEncoder and DIVEncoder in their LSTM and GRU
             forms) forward and backward on the card against the CPU at
             B = 128, T = 64 with the reader's lengths, `lstm` launches exactly
             as derived. Phase 2 also holds `lstm` at the five new shapes
             (G, B, T, H) = (2, 128, 64, 128), (1, 128, 64, 256),
             (2, 128, 64, 130), (2, 128, 64, 342), (2, 128, 64, 1024).

14. mult, gcnet, ef — the registry-only MSA families. (a) MulT from the
             registry at the Multimodal-Transformer repository's CMU-MOSI
             defaults (attention 30, 5 heads, 5 layers, the class's dropouts,
             clip 0.8, Adam 1e-3, batch 24) on seeded inputs at the MOSI
             twin's widths (audio 5, video 20, text 768, T = 50, 324
             samples, a quarter of CMU-MOSI's 1284: 14 batches, a tail of
             12 real rows as at 1284), through the port's
             generic `ClassificationTask` train step, without and with the
             discriminator (λ_d 0.1): two passes (samples/s of the second),
             a profiled window of 8 steps, neither kernel launched; steps
             1-3 and the padded tail GPU vs CPU (dropouts 0). (b) GCNet from
             the registry on 72 seeded IEMOCAP-sized dialogues (features
             130 + 1024 + 342, T = 110, lengths 20..110, two speakers, the
             seven missing-modality patterns; D_e 100, graph 100, windows
             2/2, 6 classes, dropout 0.5, time attention; batch 16, Adam
             1e-3) trained on the masked cross-entropy plus the masked
             reconstruction: two epochs (conversations/s and utterances/s
             of the second), `lstm` exactly 6 per forward, a profiled window
             of 8 steps; steps 1-3 GPU vs CPU with the LSTM base and with
             the GRU base (4 launches per forward); each MatchingAttention
             type alone GPU vs CPU. (c) EFModelAL (FcClassifier 130 → [128]
             → 128, LSTMClassifier 1024 → 128 with fc1 128 and 4 outputs,
             fusion 128) forward and backward GPU vs CPU at B = 128, T = 64
             in train mode with 28 padded rows, the BatchNorm statistics
             included, `lstm` exactly 2 per forward. Phase 2 also holds
             `lstm` at GCNet's shapes (2, 16, 110, 100) and (2, 16, 110,
             300), timed against `nn.LSTM` over 1496 and 300 input features,
             and (2, 16, 110, 300) with lengths.

15. resident, stacked — the training-systems layer. (a) phase 5's scratch
             fine-tune through `train_multimodal.main` on the device-resident
             path the driver takes by default ("auto": its budget admits the
             three splits, uploaded once, eval fused to 1024 rows) and again
             streaming, from the same seed, cuDNN deterministic, TF32
             off: epoch losses within 1e-5, test predictions equal where the
             top-2 margin is above 1e-3, `fused_mlp` once per fused eval step
             (6) and once per batch streaming (36), epoch-2 samples/s and the
             busy share of a profiled train epoch of each. (b) a two-fold CV
             of the same fine-tune (dropout 0) sequentially and with
             `--stacked-folds`: each fold's first three train steps within
             1e-4 / 1e-3 of its sequential run's; epoch 1's last step and
             epoch 2's first teacher-forced (each fold set to its sequential
             run's parameters, buffers, Adam state, step count and lr scale
             before the step, then one stacked step): the loss within 1e-4,
             the update and Adam's first moment within 1e-3 by global norm;
             the epoch losses printed beside the sequential CV's own spread
             when run again with its convolution weights in channels_last
             (cuDNN's NHWC algorithms, deterministic still);
             the same aggregate keys, `fused_mlp` once per stacked eval step
             for both folds (36). (c) UttFusion at the published widths
             (dropout 0, no test pass; 644 train samples, half the split) with
             `--stacked-runs 3` and `5` (6 and 10 `lstm` groups per launch,
             one launch per stacked step: 144)
             against the members run one after another at seed + i, each
             member's first three train steps within 1e-4 / 1e-3 of its
             run's, the padded tail (step 21, 4 real rows) and epoch 2's
             first step teacher-forced as in (b), member 1 run again with
             PyTorch's own convolutions instead of cuDNN's (cuDNN
             deterministic throughout). Phase 2 also
             holds the member-axis `fused_mlp` (K = 2, 3 at B = 128 and 1024)
             and `lstm` at K·G = 6 and 10 (B = 32, T = 50, H = 64) under
             `vmap` against their plain versions, timed, and `lstm` at the
             fused eval steps' shapes (2, 256, 50, 64) (UttFusion), (1, 256,
             50, 64) (the LSTMEncoder pretraining) and (2, 1024, 64, 128)
             (IEMOCAP).

16. mesh    — data parallelism (`mmtpu_torch/parallel/`) on the one card. (a)
             phase 15's scratch fine-tune (dropout 0, cuDNN deterministic,
             TF32 off; 384 / 128 / 128 samples) through
             `train_multimodal.main` in one process and as
             two ranks on cuda:0 over gloo (`parallel.launch` with explicit
             devices): step 1's loss within 1e-4, steps 2-3 within 1e-3, from
             the initial weights step 1's and a padded step's (28 real rows,
             none on rank 1) float64 gradients within 1e-6 of each norm, the
             epoch-2 validation loss of a float64 run (256 / 64 / 64) within
             1e-3, the ranks' state_dict
             sha256 equal after each epoch, `fused_mlp` 3 per rank as in one
             process, every file written by rank 0 alone; the gradient
             all-reduce's bytes and time per step, and samples/s of two
             processes sharing one card. (b) phase 6's UttFusion (dropout 0,
             float32; 644 train samples, half the split) the same way: step 1 and
             the padded tail (4 real rows of 32, none on rank 1) within 1e-5,
             steps 2-3 within 1e-3, step 1's gradients within 1e-4 of each
             norm, `lstm` 75 per rank. (c)
             (b)'s steps as one rank over NCCL, within 1e-5. (d) the CLI on
             one card: `--data-parallel 2` raises mmtpu's ValueError,
             `--data-parallel -1` trains in the one process. (e)-(g) the
             drivers with their own steps, at the widths of phases 9-11 on
             small splits (a train tail of 4 real rows of 32, none on rank
             1), dropout 0, one process against two ranks in the same
             launch as (a) and (b): (e) DualCMAM A→(V, T) through
             `train_cmam.main` with the MMD, moment and MI weights at 0.1,
             `lstm` 3 per batch per rank; (e') the AVMNIST C-MAM's steps
             alone, in float64: steps 1-3 and a padded step (28 real rows of
             128) within 1e-6, step 1's gradients within 1e-6 of each norm;
             (f) MMIN with its frozen teacher (`lstm` 3 per train batch per
             rank) and RedCore (its randomness neutralised; β, EMA and η
             after three float64 steps within 1e-6, and after every step of
             the run equal on both ranks); (g) Self-MM over a frozen BERT-base
             for two epochs (`lstm` 2 per batch per rank; the banks after an
             epoch-2 step within 1e-5 and bit-identical on both ranks). For
             each run: steps 1 and the padded step within 1e-5 (from the same
             initial weights), steps 2-3 within 1e-3, step 1's gradients
             within 1e-4 of each norm, the ranks' state_dict sha256 equal
             after each epoch, every file written by rank 0 alone, the `lstm`
             shapes each rank launches, the gradient all-reduce's bytes and
             time per step. Phase 2 also holds `fused_mlp` at B = 64 and 512
             and `lstm` at (2, 16, 50, 64), (2, 128, 50, 64), (1, 16, 50,
             64), (1, 16, 50, 16) and (1, 16, 50, 32), the ranks' shards.

17. monitor — the HDF5 experiment monitor (`mmtpu_torch/monitor/`), its
             storage an in-memory sink (the card's machine has no h5py), TF32
             off, dropout 0: (a) phase 5's scratch fine-tune (ResNet18/34,
             batch 128) and (b) phase 6's UttFusion (batch 32, T = 50). For
             each: three monitored steps at intervals 1 / 1 on the card and
             on the CPU, each from the same state, then the weights: the same
             record names, every record within 1e-3 (value columns of the
             leaf's max |x|, l1 and l2 relative; fractions; skewness and
             kurtosis relative; the ResNets' in a float64 step and its
             weights, their float32 records printed), and every reduction
             the card made against the CPU's of the same tensor;
             `fused_mlp` once per capture forward, `lstm` once per train
             step and per capture forward. Then one streaming train epoch
             each unmonitored, at 100 / 100 and at 1 / 1 (samples/s,
             records per step, the launches with a streamed validation
             epoch), and one profiled capture of each kind (its host share). `train_multimodal.main` with the monitor
             enabled must stop before its first step with the error that
             names h5py.
18. model axis, UMAP — (a) phase 5's scratch fine-tune at full width
             (ResNet18 / ResNet34, head 192-128-64-10, B = 128, dropout 0,
             TF32 off, cuDNN deterministic) on a (2, 2) mesh: four ranks on
             the one card over gloo, the head tensor-parallel
             (`mmtpu_torch/parallel/tensor.py`), against one process from the
             same seeded weights: float32 losses of step 1 within 1e-4 and
             steps 2-3 within 1e-3; the float64 step-1 gradients, gathered,
             within 1e-6 of each norm; the gathered parameters; one eval step's
             logits within 1e-4, the clear predictions equal, `fused_mlp`
             exactly 2 launches per eval step per rank (the shard pair
             192-64-64, then the 64-10 tail), the shard pair's kernel within
             1e-5 of its plain version; a model group's replicated parameters
             bit-identical after every step; rank 0 alone writes the
             checkpoint, the whole model's, which every rank reads back into
             its shards; each rank's step time and the model group's
             all-reduce bytes (four processes on one card: arithmetic, not
             a scaling number); both shard shapes' kernel time beside the
             plain chain's and the bound at B = 64 and 512. (b) UMAP on the
             card (`mmtpu_torch/analysis/umap_lite.py`) against the port on
             the CPU over 3,000 × 192 seeded embeddings: kNN and edges
             equal, the fuzzy set within 1e-6, the float64 layout within
             1e-4 after each of the first three epochs, the 200-epoch wall
             time.
19. multihost — 18 (a)'s job on its (2, 2) mesh made of two separately
             started launchers (`chip_smoke.py --axis-worker`, each
             `parallel.launch.launch_process` of two ranks on the card,
             meeting at a TCP store on a free local port): every rank's
             record bit for bit 18 (a)'s single launch's (its files, not
             recomputed), so within 18 (a)'s tolerances of its one process;
             `fused_mlp` exactly 2 launches per eval step per rank; rank 0
             alone writes the checkpoint.

    python3 chip_smoke.py --train-only    # build, then phases 5 and 6 alone
    python3 chip_smoke.py --reader-only   # build, the audio pretraining, phase 7
    python3 chip_smoke.py --shipped-only  # build, phase 7's .pt files, phase 8
    python3 chip_smoke.py --cmam-only     # build, phase 7's .pt files, seeded
                                          # teachers, phase 9
    python3 chip_smoke.py --msa-only      # build, a seeded UttFusion teacher,
                                          # phase 10
    python3 chip_smoke.py --self-mm-only  # build, phase 11 (a)
    python3 chip_smoke.py --mmimdb-only   # build, phase 11 (b)
    python3 chip_smoke.py --export-only   # build, seeded checkpoints, phase 12 (a)
    python3 chip_smoke.py --ks-only       # build, phase 12 (b)
    python3 chip_smoke.py --mono-only     # build, phase 12 (c)
    python3 chip_smoke.py --iemocap-only  # build, phase 13 (a)
    python3 chip_smoke.py --mmimdb-chain-only  # build, phase 13 (b) with its pretraining
    python3 chip_smoke.py --recurrent-only     # build, phase 13 (c)
    python3 chip_smoke.py --mult-only --gcnet-only --ef-only  # build, phase 14 (a)-(c)
    python3 chip_smoke.py --resident-only # build, phase 15 (a)
    python3 chip_smoke.py --stacked-only  # build, phase 2's member axis, phase 15 (b), (c)
    python3 chip_smoke.py --mesh-only     # build, phase 16 (a)-(g)
    python3 chip_smoke.py --monitor-only  # build, phase 17 (a), (b)
    python3 chip_smoke.py --model-axis-only  # build, phase 18 (a), (b)
    python3 chip_smoke.py --multihost-only   # build, phase 18 (a), phase 19

The whole script runs phases 1-4 alone, then phases 11, 12 (b), (c), 13 and
14 in a second process of its own (`chip_smoke.py --side-worker`) while
this one runs phases 5-10, 12 (a), 15 and 17, then phases 16, 18 and 19
alone: the card is idle most of the time in every one of them, the two
streams share no file, and the multi-rank phases keep the card and the host
to themselves. The second process's output follows its end.

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line `{"ok": true, "device": {...}}`. Any failure exits non-zero
without that line. There is no CPU path: without a GPU it fails. Imports
nothing of JAX or of the `mmtpu` package.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 42
HEAD_DIMS = [192, 128, 64, 10]
KERNEL_TOL = 1e-5  # fp32; kernel and cuBLAS sum in different orders
LSTM_TOL_LONG = 1e-4  # T = 400: rounding differences pass through 400 dependent steps
LSTM_GRAD_TOL = 1e-4  # kernel forward + plain recompute vs autograd through the plain scan
LIBRARY_TOL = 1e-3  # nn.LSTM (cuDNN, fp32) vs projection + kernel: the yardstick's sanity
LSTM_GATE_OPS = 20  # per (row, step, unit): 3 σ (4 ops each), 2 tanh, 3 ·, 1 +, and the freeze
CPU_TOL = 1e-3  # GPU (TF32 off) vs CPU forward of the full model
SERVE_TOL = 1e-4  # micro-batched rows vs a direct Predictor call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def smoke_config(num_samples: int = 1000, batch_size: int = 128,
                 out_root: str = "./experiments_output") -> dict:
    """The plain-dict twin of configs/avmnist/synthetic_multimodal_pretrained.yaml;
    the test split's size and batch are this run's, the rest is the file's."""
    patterns = {
        "modalities": {
            "audio": {"missing_rate": 0.0},
            "image": {"missing_rate": 0.0},
        },
    }

    def split(name, n, bs, selected, **extra):
        return {
            "dataset": "synthetic_avmnist",
            "data_fp": "unused",
            "split": name,
            "target_modality": "MULTIMODAL",
            "batch_size": bs,
            **extra,
            "kwargs": {"num_samples": n},
            "missing_patterns": {**patterns, "selected_patterns": selected},
        }

    name = "Synthetic_AVMNIST_Multimodal_Pretrained"
    return {
        "experiment": {"name": name, "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {
            "name": name,
            "model_type": "AVMNIST",
            "audio_encoder": {"__module_spec__": "resnet18", "in_channels": 1,
                              "hidden_dim": 64},
            "image_encoder": {"__module_spec__": "resnet34", "in_channels": 1,
                              "hidden_dim": 128},
            "hidden_dim": 128,
            "dropout": 0.5,
            "fusion_fn": "concat",
            "pretrained_encoders": {
                "audio": "./experiments_output/Synthetic_AVMNIST_Audio_Encoder/"
                         "models/{run_id}/encoder_audio_best.ckpt",
            },
        },
        "training": {
            "epochs": 2,
            "early_stopping": True,
            "early_stopping_patience": 5,
            "num_modalities": 2,
            "optimizer": {"name": "Adam",
                          "default_kwargs": {"lr": 0.0005, "weight_decay": 0.0001}},
            "encoder_optimizer": {"name": "Adam",
                                  "default_kwargs": {"lr": 0.0001,
                                                     "weight_decay": 0.0001}},
            "modality_specific_params": {
                "audio_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
                "image_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
            },
            "scheduler": "plateau",
            "scheduler_kwargs": {"mode": "min", "factor": 0.5, "patience": 5,
                                 "min_lr": 0.00001},
            "loss_functions": {
                "cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                  "weight": 1.0},
            },
        },
        "data": {
            "datasets": {
                "train": split("train", 256, 64, ["ai"], shuffle=True),
                "validation": split("valid", 96, 64, ["ai", "a", "i"]),
                "test": split("test", num_samples, batch_size, ["ai", "a", "i"]),
            },
        },
        "metrics": {
            "metrics": {
                "accuracy": {"function": "sklearn.metrics.accuracy_score",
                             "kwargs": {}},
                "f1_weighted": {"function": "sklearn.metrics.f1_score",
                                "kwargs": {"average": "weighted",
                                           "zero_division": 0}},
                "ConfusionMatrix": {"function": "sklearn.metrics.confusion_matrix",
                                    "kwargs": {"labels": list(range(10))}},
            },
            "groups": {"classification": ["accuracy", "f1_weighted",
                                          "ConfusionMatrix"]},
        },
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def mosi_smoke_config(num_samples: int = 686, batch_size: int = 32, seq_len: int = 50,
                      out_root: str = "./experiments_output", train_samples: int = 128,
                      validation_samples: int = 64) -> dict:
    """The plain-dict twin of configs/mosi/synthetic_utt_fusion.yaml with the
    model at its published widths (LSTM hidden 64 and pooling 'last', TextCNN
    with 128 channels, FcClassifier 192→[192, 64, 32]→3); the split sizes
    are this run's (686 is the size of the real MOSI test split; the file
    has 128 / 64 / 64), the rest is the file's."""
    def split(name, n, rates, **extra):
        return {
            "dataset": "synthetic_mosi",
            "data_fp": "unused",
            "split": name,
            "target_modality": "MULTIMODAL",
            "batch_size": batch_size,
            **extra,
            "kwargs": {"num_samples": n, **({"seq_len": seq_len} if seq_len != 50 else {})},
            "missing_patterns": {"modalities": rates},
        }

    present = {m: {"missing_rate": 0.0} for m in ("audio", "video", "text")}
    dropped = {
        "audio": {"missing_rate": 0.2, "apply_to": ["atv"]},
        "video": {"missing_rate": 0.2, "apply_to": ["atv"]},
        "text": {"missing_rate": 0.0},
    }
    train = split("train", train_samples, dropped, shuffle=True)
    train["missing_patterns"]["selected_patterns"] = ["atv"]
    name = "Synthetic_MOSI_UttFusion"
    return {
        "experiment": {"name": name, "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {
            "name": "UttFusion",
            "model_type": "utt-fusion",
            "netA": {"__module_spec__": "lstmencoder", "input_size": 5,
                     "hidden_size": 64, "embd_method": "last"},
            "netV": {"__module_spec__": "lstmencoder", "input_size": 20,
                     "hidden_size": 64, "embd_method": "last"},
            "netT": {"__module_spec__": "textcnn", "input_size": 768, "embd_size": 64,
                     "in_channels": 1, "out_channels": 128,
                     "kernel_heights": [3, 4, 5], "dropout": 0.5},
            "netC": {"__module_spec__": "fcclassifier", "input_dim": 192,
                     "layers": [192, 64, 32], "output_dim": 3, "dropout": 0.5},
            "clip": 0.5,
        },
        "training": {
            "epochs": 2,
            "early_stopping": False,
            "early_stopping_patience": 5,
            "num_modalities": 3,
            "optimizer": {"name": "Adam",
                          "default_kwargs": {"lr": 0.001, "weight_decay": 0.0001}},
            "loss_functions": {
                "cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                  "weight": 1.0},
            },
        },
        "data": {
            "datasets": {
                "train": train,
                "validation": split("valid", validation_samples, present),
                "test": split("test", num_samples, present),
            },
        },
        "metrics": {
            "metrics": {
                "MSA": {"function": "metrics.msa_binary_classification", "kwargs": {}},
                "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
            },
            "groups": {"classification": ["MSA", "accuracy"]},
        },
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def say(msg: str) -> None:
    print(msg, flush=True)


def _host_cpus() -> str:
    """The CPUs this process may use, as the OS, the affinity mask, the
    cgroup quota and torch's intra-op pool see them."""
    import os

    import torch

    try:
        quota = Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    except OSError:
        quota = "unknown"
    return (f"os.cpu_count {os.cpu_count()}, affinity {len(os.sched_getaffinity(0))}, "
            f"cgroup cpu.max {quota!r}, torch threads {torch.get_num_threads()}")


def kernel_counters() -> dict:
    """Kernel name → the wrapper that counts its launches."""
    from mmtpu_torch.ops import fused_mlp, lstm_sequence_stacked

    return {"fused_mlp": fused_mlp, "lstm": lstm_sequence_stacked}


def reset_counts() -> None:
    for wrapper in kernel_counters().values():
        wrapper.launches = 0
    designs = kernel_counters()["lstm"].design_launches
    for design in designs:
        designs[design] = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in kernel_counters().items()}


def design_counts() -> dict:
    """The `lstm` launches since the last reset_counts by design: `narrow`
    (csrc/lstm.cu), `cluster` and `grid` (csrc/lstm_wide.cu)."""
    return dict(kernel_counters()["lstm"].design_launches)


# the wide designs' launches on the paths that run them (phase 13 (c)'s
# forwards, phase 14's GCNet epochs and EFModelAL forward), summed for the
# `kernels` line: design → launches
WIDE_LAUNCHES = {"cluster": 0, "grid": 0}


def count_wide(designs: dict) -> None:
    for design in WIDE_LAUNCHES:
        WIDE_LAUNCHES[design] += designs[design]


def event_ms(fn, iters: int = 50, repeats: int = 5, warmup: int = 10) -> float:
    """Median over `repeats` of the CUDA-event time per call of `iters`
    back-to-back calls (what a caller pays per call, launch included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Median over `repeats` of the host's wall time per call of `iters`
    back-to-back calls with no synchronisation: what a launch costs the
    caller's thread (checks, allocation, the launch itself)."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_breakdown(fn, top: int = 6) -> dict:
    """Run `fn` once under torch.profiler: device time summed over every
    kernel, the host wall time of the profiled run, the device time of the
    port's own kernels, and the kernels that took the most device time.
    It records the device activity alone (the kernels and the runtime's
    launch calls, which `top_host` then lists), not the ATen operators,
    whose post-processing would cost seconds a window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if "CUDA" in str(getattr(e, "device_type", ""))]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)) for e in kernels}
    total_ms = sum(dev_us.values()) / 1e3
    ranked = sorted(kernels, key=lambda e: -dev_us[e.key])[:top]
    host_ops = sorted((e for e in events if e not in kernels),
                      key=lambda e: -e.self_cpu_time_total)[:top]
    return {
        "device_ms": total_ms,
        "profiled_wall_ms": wall_ms,
        # kernels the device ran, and the host's launch calls
        "kernel_events": sum(e.count for e in kernels),
        "launch_calls": sum(e.count for e in events if e not in kernels
                            and "LaunchKernel" in e.key),
        # by the names of the __global__ functions in mmtpu_torch/ops/csrc
        "own_ms": {name: sum(v for k, v in dev_us.items() if f"{name}_kernel" in k) / 1e3
                   for name in kernel_counters()},
        "own_calls": {name: sum(e.count for e in kernels if f"{name}_kernel" in e.key)
                      for name in kernel_counters()},
        "top": [(e.key[:70], round(dev_us[e.key] / 1e3, 4), e.count) for e in ranked],
        "top_host": [(e.key[:50], round(e.self_cpu_time_total / 1e3, 3), e.count)
                     for e in host_ops],
    }


def own_device_ms(fn, name: str, calls: int = 100) -> float:
    """Mean device time of one launch of the port's kernel `name` while `fn`
    runs `calls` times under the profiler: its summed time over the launches
    the profiler recorded. (Now and then the profiler keeps fewer events than
    were launched; a sum over a fixed count would then read low.)"""
    brk = device_breakdown(lambda: [fn() for _ in range(calls)])
    recorded = brk["own_calls"][name]
    if not recorded:
        raise AssertionError(f"the profiler recorded no {name} kernel in {calls} calls")
    if recorded != calls:
        say(f"[kernels] (the profiler kept {recorded} of {calls} {name} launches)")
    return brk["own_ms"][name] / recorded


def _bound(nbytes: float, flops: float) -> tuple:
    """The larger of bytes over the HBM rate and FLOPs over the float32
    rate, in ms, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def mlp_bound_ms(batch: int, dims) -> tuple:
    """Least time for the chain on an H100: bytes moved (x, weights, biases
    read once, logits written once) and the chain's FLOPs."""
    params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (batch * dims[0] + params + batch * dims[-1])
    flops = 2 * batch * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    return _bound(nbytes, flops)


def lstm_bound_ms(G: int, B: int, T: int, H: int, lengths=None) -> tuple:
    """Least time for the recurrence on an H100. Bytes: xw read for every
    live step, wh, h0, c0 read once, outputs, hT, cT written once (and the
    lengths). FLOPs: per live (row, step) the h·wh product, 2·H·4H, and the
    gate pass, LSTM_GATE_OPS·H. A row frozen by its length needs neither
    its xw nor any arithmetic, so with lengths only Σ min(len, T) steps count."""
    live = G * B * T if lengths is None else int(lengths.clamp(max=T).sum().item())
    nbytes = 4 * (live * 4 * H + G * H * 4 * H + 4 * G * B * H + G * B * T * H)
    if lengths is not None:
        nbytes += 4 * G * B
    flops = live * (2 * H * 4 * H + LSTM_GATE_OPS * H)
    return _bound(nbytes, flops)


def phase_build() -> None:
    from mmtpu_torch.ops import KERNELS, _build

    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    say(f"[build] {list(KERNELS)} in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, together; sm_90a) → {_build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.strip().splitlines():
            say(f"[build] {name}: {line.strip()}")


def phase_kernels_mlp(dev) -> dict:
    """fused_mlp vs fused_mlp_reference on the card; timings at the batch
    sizes the path uses (predict batch 128, and 1024)."""
    import torch

    from mmtpu_torch.ops import fused_mlp, fused_mlp_reference
    from mmtpu_torch.ops.fused_mlp import _launch as mlp_launch
    from mmtpu_torch.ops.fused_mlp import bulk_copy_ok, chain_plan

    g = torch.Generator().manual_seed(SEED)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def layers(dims):
        ws = [(torch.randn(o, i, generator=g) / i ** 0.5).to(dev)
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [(0.1 * torch.randn(o, generator=g)).to(dev) for o in dims[1:]]
        return ws, bs

    def misaligned(w):
        """The same matrix, contiguous, 4 bytes into a buffer of its own: no
        bulk copy can bring it, the kernel copies it with plain loads."""
        buf = torch.empty(w.numel() + 1, device=dev)
        buf[1:].copy_(w.reshape(-1))
        return buf[1:].view_as(w)

    max_err = shipped_err = 0.0
    # (dims, batch, what is special): the head at the path's batch sizes, odd
    # widths, layer 1 off the 16-byte grid, and a chain too wide to stay in
    # shared memory (16.8 MB of weights, streamed through it)
    cases = [(HEAD_DIMS, b, "") for b in (1, 37, 64, 128, 512, 1024)] + [
        (SHIPPED_HEAD_DIMS, b, "") for b in (128, 1024)] + [
        ([100, 300, 7], 37, ""),
        (HEAD_DIMS, 128, "layer 1 a misaligned view"),
        ([2048, 2048, 10], 64, "weights streamed"),
    ]
    for dims, batch, special in cases:
        ws, bs = layers(dims)
        if "misaligned" in special:
            ws[0] = misaligned(ws[0])
            if bulk_copy_ok(ws[0]) or not bulk_copy_ok(ws[1]):
                raise AssertionError("the misaligned view is not what it should be")
        if "streamed" in special and chain_plan(batch, tuple(dims), num_sms).resident:
            raise AssertionError(f"fused_mlp {dims}: expected a streamed plan")
        x = torch.randn(batch, dims[0], generator=g).to(dev)
        got = fused_mlp(x, ws, bs)
        want = fused_mlp_reference(x, ws, bs)
        torch.cuda.synchronize()
        label = f"fused_mlp {dims} B={batch}" + (f" ({special})" if special else "")
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: bad output {got.shape}")
        err = (got - want).abs().max().item()
        say(f"[kernels] {label}: max |kernel - plain| = {err:.3e}")
        if err > KERNEL_TOL:
            raise AssertionError(f"{label}: error {err} > {KERNEL_TOL}")
        max_err = max(max_err, err)
        if dims == SHIPPED_HEAD_DIMS:
            shipped_err = max(shipped_err, err)

    timings = {}
    for dims in (HEAD_DIMS, SHIPPED_HEAD_DIMS):
        ws, bs = layers(dims)
        for batch in (128, 1024) + (MESH_MLP_BATCHES if dims == HEAD_DIMS else ()):
            x = torch.randn(batch, dims[0], generator=g).to(dev)
            # turns: plain, kernel, kernel, plain
            p1 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
            k1 = event_ms(lambda: fused_mlp(x, ws, bs))
            k2 = event_ms(lambda: fused_mlp(x, ws, bs))
            p2 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
            kh = host_ms(lambda: fused_mlp(x, ws, bs))
            # the same launch through the operator a traced graph holds, and
            # `_launch` alone (what the wrapper's eager call adds to it)
            oh = host_ms(lambda: torch.ops.mmtpu.fused_mlp(x, ws, bs))
            dh = host_ms(lambda: mlp_launch(x, ws, bs))
            kd = own_device_ms(lambda: fused_mlp(x, ws, bs), "fused_mlp")
            pd = device_breakdown(lambda: [fused_mlp_reference(x, ws, bs) for _ in range(100)])
            pd = pd["device_ms"] / 100
            bound, bound_by = mlp_bound_ms(batch, dims)
            timings[(dims[0], batch)] = {
                "ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
                "device_ms": kd, "plain_device_ms": pd, "host_ms": kh,
                "op_host_ms": oh, "direct_host_ms": dh,
                "bound_ms": bound, "bound_by": bound_by,
            }
            say(f"[kernels] fused_mlp B={batch} {dims}: per call kernel "
                f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms (events); host per launch "
                f"{kh:.4f} ms (wall, no sync), through the operator {oh:.4f} ms, _launch "
                f"alone {dh:.4f} ms; device "
                f"time kernel {kd} ms, plain {pd} ms (profiler); bound {bound:.6f} ms "
                f"({bound_by})")
    return {"max_err": max_err, "shipped_err": shipped_err,
            "timings": {b: timings[(HEAD_DIMS[0], b)] for b in (128, 1024)},
            "mesh": {b: timings[(HEAD_DIMS[0], b)] for b in MESH_MLP_BATCHES},
            "shipped": {b: timings[(SHIPPED_HEAD_DIMS[0], b)] for b in (128, 1024)}}


# LSTM shapes: (G, B, T, H, lengths in [0, T], non-zero h0/c0, tolerance, timed).
# Every shape is held against the plain scan; the script times the main shape,
# the widths where the narrow design lost to `nn.LSTM` (H >= 256), now wide, and the ranks'
# shards, to stay inside its time (the other shapes' times stand in PERF.md §6;
# `True` in a case's last field times it again)
LSTM_CASES = [
    (1, 32, 50, 64, False, False, KERNEL_TOL, False),
    (2, 32, 50, 64, False, False, KERNEL_TOL, True),   # the UttFusion forward
    (1, 128, 50, 32, False, False, KERNEL_TOL, False),
    (1, 32, 400, 64, True, False, LSTM_TOL_LONG, False),
    (1, 5, 7, 24, False, True, KERNEL_TOL, False),
    (1, 32, 50, 128, False, False, KERNEL_TOL, False),
    (2, 64, 50, 64, False, False, KERNEL_TOL, False),  # the server's largest micro-batch
    (1, 32, 50, 16, False, False, KERNEL_TOL, False),   # Self-MM's audio AuViSubNet
    (1, 32, 50, 32, False, False, KERNEL_TOL, False),   # Self-MM's video AuViSubNet
    (2, 128, 64, 128, False, False, KERNEL_TOL, False),  # IEMOCAP's netA and netV stacked
    (1, 128, 64, 256, False, False, KERNEL_TOL, True),  # VariationalLSTMEncoder at 2 × 128
    (2, 128, 64, 130, False, False, KERNEL_TOL, False),  # SeqEncoder's audio bi-LSTM
    (2, 128, 64, 342, False, False, KERNEL_TOL, True),  # SeqEncoder's video bi-LSTM
    (2, 128, 64, 1024, False, False, KERNEL_TOL, True),  # SeqEncoder's text bi-LSTM
    (2, 16, 110, 100, False, False, KERNEL_TOL, False),  # GCNet's base bi-LSTM (D_e 100)
    (2, 16, 110, 300, False, False, KERNEL_TOL, True),  # GCNet's fusion bi-LSTM (d_h 300)
    (2, 16, 110, 300, True, False, KERNEL_TOL, False),  # the same with lengths
    (2, 256, 50, 64, False, False, KERNEL_TOL, False),  # UttFusion's fused eval step, 8 × 32
    (1, 256, 50, 64, False, False, KERNEL_TOL, False),  # the LSTMEncoder pretraining's
    (2, 1024, 64, 128, False, False, KERNEL_TOL, False),  # IEMOCAP's fused eval step, 8 × 128
    (2, 16, 50, 64, False, False, KERNEL_TOL, True),  # UttFusion's train batch on 2 ranks
    (2, 128, 50, 64, False, False, KERNEL_TOL, True),  # its fused eval step on 2 ranks
    (1, 16, 50, 64, False, False, KERNEL_TOL, False),  # DualCMAM's and MMIN's G=1 nets, 2 ranks
    (1, 16, 50, 16, False, False, KERNEL_TOL, False),  # Self-MM's audio AuViSubNet on 2 ranks
    (1, 16, 50, 32, False, False, KERNEL_TOL, False),  # Self-MM's video AuViSubNet on 2 ranks
    # the wide designs (csrc/lstm_wide.cu): the four wide shapes with lengths
    # (0 and T among them) and a state; ragged unit slices (342, 300 over 8 or
    # 16 blocks) with a batch that no tile divides; the member fold at a wide
    # H; 400 steps; the grid design at a batch of 37
    (1, 128, 64, 256, True, True, KERNEL_TOL, False),
    (2, 128, 64, 342, True, True, KERNEL_TOL, False),
    (2, 128, 64, 1024, True, True, KERNEL_TOL, False),
    (2, 16, 110, 300, True, True, KERNEL_TOL, False),
    (2, 50, 30, 342, True, True, KERNEL_TOL, False),
    (2, 37, 20, 1024, True, True, KERNEL_TOL, False),
    (64, 3, 20, 300, True, True, KERNEL_TOL, False),
    (1, 16, 400, 256, True, False, LSTM_TOL_LONG, False),
]
# the widths where the narrow design lost to `nn.LSTM` until the wide designs
WIDE_LSTM = ((1, 128, 64, 256), (2, 128, 64, 342), (2, 128, 64, 1024), (2, 16, 110, 300))
# the crossover between the narrow and the wide designs, and the cluster
# design against the grid design: each shape timed on every design that
# takes it, in turns
CROSSOVER_LSTM = ((2, 32, 50, 64), (2, 16, 110, 100), (2, 128, 64, 128), (2, 128, 64, 130),
                  (1, 128, 64, 256), (2, 16, 110, 300), (2, 128, 64, 342))
# phase 16's shards: each of two ranks holds half of a global batch ((a)-(b):
# UttFusion's, timed; (e)-(g): the C-MAM, MMIN and Self-MM launches, MMIN's
# student pair being UttFusion's shape, checked against the plain scan and
# not timed, to keep the script's time: PERF.md §6 has their times)
MESH_LSTM = ((2, 16, 50, 64), (2, 128, 50, 64), (1, 16, 50, 64), (1, 16, 50, 16),
             (1, 16, 50, 32))
MESH_MLP_BATCHES = (64, 512)  # AVMNIST's streaming eval batch of 128 and fused step of 1024
# the gradient checks: (G, B, T, H, lengths, non-zero h0/c0)
LSTM_GRAD_CASES = [(2, 9, 11, 24, True, True), (1, 32, 50, 16, False, False),
                   (1, 32, 50, 32, False, False)]
LSTM_MAIN = (2, 32, 50, 64)
LSTM_INPUT_SIZES = (5, 20)  # MOSI audio and video feature widths, by group
# per group the library LSTM's input width where it is not MOSI's: Self-MM's
# video LSTM 20→32; IEMOCAP's comparE 130 and denseface 342; SeqEncoder's
# streams, whose hidden size is their input width; GCNet's stacks' first
# layers: the base over 130 + 1024 + 342 features, the fusion over d_h = 300
LSTM_LIBRARY_INPUT = {(1, 32, 50, 32): (20,), (1, 16, 50, 32): (20,),
                      (2, 128, 64, 128): (130, 342),
                      (1, 128, 64, 256): (130,), (2, 128, 64, 130): (130,),
                      (2, 128, 64, 342): (342,), (2, 128, 64, 1024): (1024,),
                      (2, 16, 110, 100): (1496,), (2, 16, 110, 300): (300,),
                      (2, 1024, 64, 128): (130, 342)}
SLOW_CALL_MS = 1.0  # a call slower than this is timed over fewer iterations


def _lstm_inputs(dev, G, B, T, H, with_len, with_state, seed):
    import torch

    g = np.random.default_rng(seed)
    xw = g.normal(size=(G, B, T, 4 * H)).astype(np.float32)
    wh = (g.normal(size=(G, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    state = (0.5 * g.normal(size=(2, G, B, H))).astype(np.float32) * float(with_state)
    lengths = g.integers(0, T + 1, size=(G, B)).astype(np.int32) if with_len else None
    if lengths is not None and B >= 2:  # the edges: a row that never runs, one that never stops
        lengths[:, 0], lengths[:, -1] = 0, T
    to = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    return to(xw), to(wh), to(state[0]), to(state[1]), to(lengths)


def _lstm_library(dev, G, B, T, H, seed):
    """The library's call for the same function without lengths: per group a
    `torch.nn.LSTM` holding the weights of an `nn.Linear` projection and a
    recurrent matrix `wh`. Unlike the kernel it includes the projection
    x·Wi + b, so it is set against projection + kernel. Returns (library
    call, projection + kernel call, max |difference| of their outputs)."""
    import torch
    from torch import nn

    from mmtpu_torch.ops import lstm_sequence_stacked

    gen = torch.Generator().manual_seed(seed)
    xs, wis, whs, rnns = [], [], [], []
    sizes = LSTM_LIBRARY_INPUT.get((G, B, T, H), LSTM_INPUT_SIZES)
    for g in range(G):
        size = sizes[g % len(sizes)]
        wi = nn.Linear(size, 4 * H)
        wh = torch.randn(H, 4 * H, generator=gen) / H ** 0.5
        rnn = nn.LSTM(size, H, batch_first=True)
        with torch.no_grad():  # same gate order [i, f, g, o]; matrices transposed
            rnn.weight_ih_l0.copy_(wi.weight)
            rnn.bias_ih_l0.copy_(wi.bias)
            rnn.weight_hh_l0.copy_(wh.t())
            rnn.bias_hh_l0.zero_()
        xs.append(torch.randn(B, T, size, generator=gen).to(dev))
        wis.append(wi.to(dev))
        whs.append(wh.to(dev))
        rnns.append(rnn.to(dev).eval())
    @torch.no_grad()
    def library():
        return [rnn(x)[0] for rnn, x in zip(rnns, xs)]

    @torch.no_grad()
    def ours():
        return lstm_sequence_stacked([wi(x) for wi, x in zip(wis, xs)], whs)[0]

    diff = max((a - b).abs().max().item() for a, b in zip(library(), ours()))
    return library, ours, diff


def phase_kernels_lstm(dev) -> dict:
    """lstm kernel vs the plain scan on the card (outputs, hT, cT), its
    gradient vs autograd through the plain scan, and timings per call beside
    the plain scan and nn.LSTM."""
    import torch

    from mmtpu_torch.ops import _build, lstm_sequence_stacked, lstm_stacked_reference
    from mmtpu_torch.ops.lstm import (MAX_GROUPS, NARROW_MAX_HIDDEN, _launch as lstm_launch,
                                      max_active_clusters, wide_plan)

    torch.backends.cudnn.allow_tf32 = False  # nn.LSTM in fp32, as the kernel
    index, sms = _build.sm90_device(dev, "lstm")
    occupancy = max_active_clusters(index)
    say(f"[kernels] lstm: cudaOccupancyMaxActiveClusters (S, clusters), a block per SM: "
        f"{occupancy}; narrow design at H <= {NARROW_MAX_HIDDEN}")

    def plan_of(G, B, H, design=None):
        wide = design not in (None, "narrow") or (design is None and H > NARROW_MAX_HIDDEN)
        return wide_plan(min(G, MAX_GROUPS), B, H, sms, occupancy if wide else (), design)

    def describe(plan):
        active = dict(occupancy).get(plan.cluster)
        return (f"{plan.design} design, S={plan.cluster}, Bt={plan.rows}, {plan.blocks} blocks "
                f"of {plan.threads} threads, {plan.smem} B shared"
                + (f", {active} clusters of {plan.cluster} resident at once"
                   if plan.design == "cluster" else ""))

    max_err = 0.0
    timings, errors, plans = {}, {}, {}
    for seed, (G, B, T, H, with_len, with_state, tol, timed) in enumerate(LSTM_CASES):
        xw, wh, h0, c0, lengths = _lstm_inputs(dev, G, B, T, H, with_len, with_state, seed)
        if not with_state:  # as the encoders call it: no state tensor at all
            h0 = c0 = None
        with torch.no_grad():
            out, (h, c) = lstm_sequence_stacked(list(xw), list(wh), h0, c0, lengths)
            want, (want_h, want_c) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
        torch.cuda.synchronize()
        if out.shape != (G, B, T, H) or not all(torch.isfinite(t).all() for t in (out, h, c)):
            raise AssertionError(f"lstm G={G} B={B} T={T} H={H}: bad output {out.shape}")
        errs = [(a - b).abs().max().item() for a, b in ((out, want), (h, want_h), (c, want_c))]
        shape = f"G={G} B={B} T={T} H={H}" + (" lengths" if with_len else "") \
            + (" h0/c0≠0" if with_state else "")
        plan = plans[(G, B, T, H)] = plan_of(G, B, H)
        say(f"[kernels] lstm {shape}: max |kernel - plain| outputs {errs[0]:.3e}, "
            f"hT {errs[1]:.3e}, cT {errs[2]:.3e} (tolerance {tol}); {describe(plan)}")
        if max(errs) > tol:
            raise AssertionError(f"lstm {shape}: error {max(errs)} > {tol}")
        max_err = max(max_err, *errs)
        errors[(G, B, T, H)] = max(errors.get((G, B, T, H), 0.0), *errs)
        if not timed:
            continue

        xws, whs = list(xw), list(wh)  # per-group tensors, as the encoders hand them over

        def kernel():
            return lstm_sequence_stacked(xws, whs, h0, c0, lengths)

        def plain():
            return lstm_stacked_reference(xw, wh, h0, c0, lengths)

        slow = dict(iters=5, repeats=3, warmup=2)  # the scan is ~10 launches per step
        with torch.no_grad():
            long_call = event_ms(kernel, iters=2, repeats=1, warmup=1) > SLOW_CALL_MS
            # a call above SLOW_CALL_MS (H >= 256) is timed over 3 × 2 calls, for room
            # (its host time over 20 × 3, which a few long calls leave noisy)
            ev = dict(iters=3, repeats=2, warmup=1) if long_call else {}
            hv = dict(iters=20, repeats=3) if long_call else {}
            p1 = event_ms(plain, **slow)
            k1 = event_ms(kernel, **ev)
            k2 = event_ms(kernel, **ev)
            p2 = event_ms(plain, **slow)
            kh = host_ms(kernel, **hv)
            oh = host_ms(lambda: torch.ops.mmtpu.lstm(xws, whs, h0, c0, lengths), **hv)
            dh = host_ms(lambda: lstm_launch(xws, whs, h0, c0, lengths), **hv)
            kd = own_device_ms(kernel, "lstm", calls=10 if long_call else 100)
            pd = device_breakdown(lambda: [plain() for _ in range(3)])["device_ms"] / 3
        bound, bound_by = lstm_bound_ms(G, B, T, H, lengths)
        t = {"ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
             "device_ms": kd, "plain_device_ms": pd, "host_ms": kh, "op_host_ms": oh,
             "direct_host_ms": dh, "bound_ms": bound, "bound_by": bound_by, "serial_steps": T,
             "design": plan.design, "cluster": plan.cluster, "rows_per_tile": plan.rows,
             "blocks": plan.blocks}
        line = (f"[kernels] lstm {shape} ({describe(plan)}): per call kernel "
                f"{k1:.4f}/{k2:.4f} ms, plain "
                f"{p1:.4f}/{p2:.4f} ms (events); host per launch {kh:.4f} ms (wall, no sync), "
                f"through the operator {oh:.4f} ms, _launch alone {dh:.4f} ms; "
                f"device time kernel {kd} ms, plain {pd} ms "
                f"(profiler); bound {bound:.6f} ms ({bound_by}); serial chain {T} steps")
        if not with_len:  # nn.LSTM has no length freeze of this kind
            library, ours, diff = _lstm_library(dev, G, B, T, H, seed)
            if diff > LIBRARY_TOL:
                raise AssertionError(f"lstm {shape}: nn.LSTM differs by {diff}")
            lib_calls = 10  # a profiled window of 100 nn.LSTM calls holds ~10^4 events
            l1 = event_ms(library, **ev)
            o1 = event_ms(ours, **ev)
            o2 = event_ms(ours, **ev)
            l2 = event_ms(library, **ev)
            ld = device_breakdown(lambda: [library() for _ in range(lib_calls)])["device_ms"] \
                / lib_calls
            t.update(library_ms=statistics.mean([l1, l2]), library_device_ms=ld,
                     with_projection_ms=statistics.mean([o1, o2]))
            line += (f"; nn.LSTM ×{G} (projection included) {l1:.4f}/{l2:.4f} ms, device "
                     f"{ld} ms, vs projection + kernel {o1:.4f}/{o2:.4f} ms, "
                     f"max |difference| {diff:.3e}")
        say(line)
        timings[(G, B, T, H)] = t

    # the crossover: each shape on every design that takes it, in turns
    # (narrow, cluster, grid, grid, cluster, narrow)
    crossover = {}
    for G, B, T, H in CROSSOVER_LSTM:
        designs = []
        for design in ("narrow", "cluster", "grid"):
            try:
                designs.append((design, plan_of(G, B, H, design)))
            except ValueError:  # no layout of this design takes the shape
                pass
        xw, wh, _, _, _ = _lstm_inputs(dev, G, B, T, H, False, False, 7)
        xws, whs = list(xw), list(wh)
        runs = {}
        with torch.no_grad():
            want, _ = lstm_stacked_reference(xw, wh)
            for design, _ in designs + designs[::-1]:
                out = lstm_launch(xws, whs, None, None, None, design)[0]
                err = (out - want).abs().max().item()
                if err > KERNEL_TOL:
                    raise AssertionError(f"lstm crossover {design} G={G} B={B} T={T} H={H}: "
                                         f"error {err}")
                runs.setdefault(design, []).append(event_ms(
                    lambda: lstm_launch(xws, whs, None, None, None, design),
                    iters=5, repeats=3, warmup=2))
        crossover[(G, B, T, H)] = {d: statistics.mean(v) for d, v in runs.items()}
        say(f"[kernels] lstm designs at G={G} B={B} T={T} H={H}, per call (events), in turns: "
            + "; ".join(f"{d} {runs[d][0]:.4f}/{runs[d][1]:.4f} ms ({describe(pl)})"
                        for d, pl in designs)
            + f"; chosen: {plan_of(G, B, H).design}")

    # gradient: kernel forward + plain recompute vs autograd through the plain scan
    grad_err = 0.0
    for G, B, T, H, with_len, with_state in LSTM_GRAD_CASES:
        cots = None
        grads = []
        for fn in (lstm_sequence_stacked, lstm_stacked_reference):
            xw, wh, h0, c0, lengths = _lstm_inputs(dev, G, B, T, H, with_len, with_state, 99)
            leaves = [t.requires_grad_() for t in (xw, wh)]
            if with_state:
                leaves += [t.requires_grad_() for t in (h0, c0)]
            else:  # as the encoders call it: no state tensor at all
                h0 = c0 = None
            out, (h, c) = fn(*leaves[:2], h0, c0, lengths)
            if cots is None:
                gen = torch.Generator().manual_seed(SEED)
                cots = [torch.randn(t.shape, generator=gen).to(dev) for t in (out, h, c)]
            grads.append(torch.autograd.grad((out, h, c), leaves, cots))
        err = max((a - b).abs().max().item() for a, b in zip(*grads))
        grad_err = max(grad_err, err)
        shape = f"G={G} B={B} T={T} H={H}" + (", lengths, h0/c0≠0" if with_len else "")
        say(f"[kernels] lstm gradient ({shape}): max |autograd.Function - autograd through "
            f"the plain scan| = {err:.3e} (tolerance {LSTM_GRAD_TOL})")
        if err > LSTM_GRAD_TOL:
            raise AssertionError(f"lstm gradient at {shape} differs by {err}")
    return {"max_err": max_err, "grad_err": grad_err, "timings": timings, "errors": errors,
            "plans": plans, "crossover": crossover, "occupancy": occupancy}


# What the predict and serve phases need to know of each model's path.
AVMNIST_PATH = {
    "label": "AVMNIST", "kernel": "fused_mlp", "classes": 10,
    "patterns": {"ai", "a", "i"}, "keys": ["audio", "image"],
}
MOSI_PATH = {
    "label": "UttFusion", "kernel": "lstm", "classes": 3,
    "patterns": {"atv", "at", "av", "tv", "a", "t", "v"}, "keys": ["audio", "video", "text"],
}


def phase_predict(dev, work: Path, cfg_path: Path, path: dict) -> dict:
    import torch

    from mmtpu_torch.checkpoints import save_pth
    from mmtpu_torch.cli import common, predict
    from mmtpu_torch.models import seeded_init
    from mmtpu_torch.train.step import make_eval_step

    tag, kernel = f"[predict {path['label']}]", path["kernel"]
    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    model = seeded_init(common.build_model_from_config(cfg.model), SEED)
    ckpt = save_pth(model, common.checkpoint_path(cfg, "best"))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"{tag} full-width model ({n_params} parameters), seeded weights → {ckpt}")

    out_json = work / f"predictions_{path['label']}.json"
    args = predict.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1", "--out", str(out_json)]
    )
    reset_counts()
    t0 = time.perf_counter()
    _, records, summary = predict.run(args)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    data = json.loads(out_json.read_text())
    if set(data) != {"split", "checkpoint", "accuracy_per_pattern", "predictions"}:
        raise AssertionError(f"predictions JSON keys {sorted(data)}")
    test = cfg.data.datasets["test"]
    n_visits = len(path["patterns"]) * test.kwargs["num_samples"]
    n_batches = -(-n_visits // test.batch_size)
    if len(records) != n_visits or set(summary) != path["patterns"]:
        raise AssertionError(f"{len(records)} records, patterns {sorted(summary)}")
    # one launch per eval forward: none means the path went round the kernel,
    # more means a route launches it twice
    if counts[kernel] != n_batches:
        raise AssertionError(
            f"predict: {kernel} launched {counts[kernel]} times in {n_batches} batches")
    say(f"{tag} {len(records)} visits in {n_batches} batches, {seconds:.3f} s through "
        f"predict.run ({len(records) / seconds:.1f} visits/s, start-up included); "
        f"per-pattern accuracy {summary}; kernel launches {counts}")

    # steady state: the same pass with the model already built and loaded
    task, loader = predict.build_task_and_loader(cfg, args, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records2, _ = predict.predict_split(task, loader, dev)
    steady = time.perf_counter() - t0
    say(f"{tag} steady pass: {len(records2)} visits in {steady:.3f} s "
        f"({len(records2) / steady:.1f} visits/s)")
    if [r["pred"] for r in records2] != [r["pred"] for r in records]:
        raise AssertionError("two predict passes disagree")
    brk = device_breakdown(lambda: predict.predict_split(task, loader, dev))
    say(f"{tag} profiled pass: device busy {brk['device_ms']:.3f} ms of "
        f"{brk['profiled_wall_ms']:.3f} ms wall ({brk['device_ms'] / (steady * 1e3):.3f} "
        f"of the unprofiled steady pass); {kernel} {brk['own_ms'][kernel]:.4f} ms; "
        f"top kernels (name, ms, count) {brk['top']}; top host ops by self CPU time "
        f"(name, ms, count) {brk['top_host']}")

    # the same batches on the CPU: first two and the padded tail
    cpu_task, _ = predict.build_task_and_loader(cfg, args, torch.device("cpu"))
    batches = list(loader)
    picks = [0, 1, len(batches) - 1]
    gpu_step = make_eval_step(task, dev)
    cpu_step = make_eval_step(cpu_task, torch.device("cpu"))
    worst = 0.0
    for i in picks:
        g_out = gpu_step(batches[i])
        c_out = cpu_step(batches[i])
        g_logits = g_out["logits"].cpu()
        c_logits = c_out["logits"]
        if (g_logits.shape != (loader.batch_size, path["classes"])
                or not torch.isfinite(g_logits).all()):
            raise AssertionError(f"batch {i}: logits {tuple(g_logits.shape)} not finite")
        err = (g_logits - c_logits).abs().max().item()
        worst = max(worst, err)
        top2 = c_logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * CPU_TOL
        if not torch.equal(g_out["preds"].cpu()[clear], c_out["preds"][clear]):
            raise AssertionError(f"batch {i}: GPU and CPU predictions differ")
    say(f"{tag} GPU vs CPU logits on batches {picks}: max |diff| = {worst:.3e} "
        f"(tolerance {CPU_TOL}, TF32 off)")
    if worst > CPU_TOL:
        raise AssertionError(f"GPU vs CPU logits differ by {worst}")
    return {"launches": counts[kernel], "visits_per_s": len(records) / seconds,
            "steady_visits_per_s": len(records2) / steady}


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(cfg_path: Path, path: dict, inputs: dict, argv=None, reference=None,
                tol: float = SERVE_TOL) -> dict:
    """`inputs`: input key → (n, ...) array, one row per request, in the
    model's key order; a missing modality is a zeroed row. `argv` gives the
    server's source (default: the config); the answers are held against
    `reference` (default: the served model called directly) within `tol`.
    The path's kernel runs once per micro-batch; a path without one
    (`kernel` None) launches neither."""
    from mmtpu_torch.cli import serve

    kernel, keys = path["kernel"], path["keys"]
    tag = f"[serve {path['label']}{' ' + argv[0] if argv else ''}]"
    args = serve.arg_parser().parse_args(
        argv or ["--config", str(cfg_path), "--run_id", "1"])
    predictor, meta = serve.load_model(args)
    n = len(inputs[keys[0]])
    bodies = [json.dumps({k: inputs[k][i].tolist() for k in keys}).encode() for i in range(n)]
    say(f"{tag} {n} requests of {len(bodies[0]) / 1e3:.1f} KB of JSON each")

    def round_trip(url):
        """n concurrent /predict requests (16 clients); (answers, seconds)."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=16) as pool:
            answers = list(pool.map(lambda b: _post(url, b), bodies))
        return answers, time.perf_counter() - t0

    classes = path["classes"]

    def null_model(*arrays):  # the HTTP/JSON path's ceiling: no model at all
        rows = len(arrays[0])
        return {"logits": np.zeros((rows, classes), np.float32),
                "preds": np.zeros(rows, np.int64),
                "probs": np.full((rows, classes), 1.0 / classes, np.float32)}

    with serve.ServerThread(null_model, meta, max_batch=64, max_wait_ms=5.0) as st:
        _, null_cold = round_trip(f"{st.url}/predict")
        _, null_s = round_trip(f"{st.url}/predict")
    say(f"{tag} the same {n} requests to a server with no model: {null_cold:.3f} s "
        f"first round, {null_s:.3f} s second round ({n / null_s:.1f} requests/s, "
        f"host HTTP/JSON only)")

    reset_counts()
    with serve.ServerThread(predictor, meta, max_batch=64, max_wait_ms=5.0) as st:
        health = _get(f"{st.url}/health")
        got_meta = _get(f"{st.url}/meta")
        _, cold = round_trip(f"{st.url}/predict")  # first use of each batch bucket
        answers, seconds = round_trip(f"{st.url}/predict")
        batch_answer = _post(f"{st.url}/predict_batch", json.dumps(
            {k: inputs[k][:8].tolist() for k in keys}).encode())
        try:  # a request that lacks an input key is refused, not filled in
            _post(f"{st.url}/predict", json.dumps(
                {k: inputs[k][0].tolist() for k in keys[:-1]}).encode())
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
            e.close()
        stats = _get(f"{st.url}/stats")
        counts = read_counts()
        launches = counts[kernel] if kernel else sum(counts.values())
    if health.get("status") != "ok" or got_meta["input_keys"] != keys:
        raise AssertionError(f"/health {health}, /meta {got_meta}")
    if refused != 400:
        raise AssertionError(f"a request without {keys[-1]!r} got {refused}, expected 400")
    say(f"{tag} {n} concurrent /predict (16 clients): {cold:.3f} s first round, "
        f"{seconds:.3f} s second round ({n / seconds:.1f} requests/s); /stats {stats}; "
        f"launches while serving {counts}; request without {keys[-1]!r} → 400")
    # one launch per micro-batch, and one for /predict_batch
    if launches != (stats["batches"] + 1 if kernel else 0):
        raise AssertionError(f"serve: launches {counts} for {stats['batches']} batches + 1")
    if stats["requests"] != 2 * n:
        raise AssertionError(f"/stats counted {stats['requests']} requests, sent {2 * n}")

    direct = (reference or predictor)(**inputs)
    worst = 0.0
    for i, ans in enumerate(answers):
        diff = float(np.abs(np.asarray(ans["logits"]) - direct["logits"][i]).max())
        worst = max(worst, diff)
        top2 = np.sort(direct["logits"][i])[-2:]
        if top2[1] - top2[0] > 2 * tol and ans["preds"] != int(direct["preds"][i]):
            raise AssertionError(f"/predict row {i}: pred {ans['preds']} != "
                                 f"{int(direct['preds'][i])}")
    for i in range(8):
        diff = float(np.abs(np.asarray(batch_answer["logits"][i]) - direct["logits"][i]).max())
        worst = max(worst, diff)
    say(f"{tag} answers vs Predictor called directly: max |logit diff| = {worst:.3e} "
        f"(tolerance {tol})")
    if worst > tol:
        raise AssertionError(f"served logits differ from the Predictor by {worst}")
    return {"launches": launches, "requests_per_s": n / seconds,
            "null_requests_per_s": n / null_s}


def avmnist_requests() -> dict:
    """48 samples: a third with the image zeroed, a third with the audio."""
    from mmtpu_torch.data import SyntheticAVMNIST
    from mmtpu_torch.modalities import Modality

    ds = SyntheticAVMNIST(split="test", num_samples=48, seed=SEED + 1)
    audio = ds.arrays[Modality.AUDIO].copy()
    image = ds.arrays[Modality.IMAGE].copy()
    image[0::3] = 0.0
    audio[1::3] = 0.0
    return {"audio": audio, "image": image}


def mosi_requests() -> dict:
    """36 samples: a third with the text zeroed, a third with audio and
    video zeroed, a third whole."""
    from mmtpu_torch.data import SyntheticMOSI
    from mmtpu_torch.modalities import Modality

    ds = SyntheticMOSI(split="test", num_samples=36, seed=SEED + 1)
    audio = ds.arrays[Modality.AUDIO].copy()
    video = ds.arrays[Modality.VIDEO].copy()
    text = ds.arrays[Modality.TEXT].copy()
    text[0::3] = 0.0
    audio[1::3] = 0.0
    video[1::3] = 0.0
    return {"audio": audio, "video": video, "text": text}


# The training phase: the synthetic configs' widths, models and optimizers;
# only the sample counts are this run's (the files have 256/96/96 in batches of 64).
TRAIN_SAMPLES = {"train": 2048, "validation": 512, "test": 512}
TRAIN_BATCH = 128
TRAIN_EPOCHS = 2
TRAIN_LOSS_RTOL = 1e-4  # step 1, GPU (TF32 off) vs CPU
TRAIN_GRAD_TOL = 1e-3  # of a gradient's norm: float32 parameters above it are counted
TRAIN_GRAD64_TOL = 1e-6  # of a gradient's norm, GPU vs CPU in float64 (phase_train_check)
TRAIN_LATER_RTOL = 1e-3  # steps 2-3: Adam's first steps amplify rounding near g = 0
MONO_NAME = "Synthetic_AVMNIST_Audio_Encoder"
SCRATCH_NAME = "Synthetic_AVMNIST_Multimodal_Scratch"


def train_configs(out_root: str) -> dict:
    """Plain-dict twins of configs/avmnist/synthetic_mono_audio.yaml ("mono")
    and synthetic_multimodal_pretrained.yaml ("pretrained"; its handoff named
    by the `.ckpt` spelling the file uses), and the same fine-tune from
    scratch ("scratch"), with this run's sample counts and batch."""
    import copy

    multi = smoke_config(out_root=out_root)
    multi["model"]["pretrained_encoders"]["audio"] = (
        f"{out_root}/{MONO_NAME}/models/{{run_id}}/encoder_audio_best.ckpt")
    multi["training"]["epochs"] = TRAIN_EPOCHS
    for split, n in TRAIN_SAMPLES.items():
        multi["data"]["datasets"][split]["batch_size"] = TRAIN_BATCH
        multi["data"]["datasets"][split]["kwargs"]["num_samples"] = n

    mono = copy.deepcopy(multi)
    mono["experiment"]["name"] = MONO_NAME
    mono["model"] = {"name": MONO_NAME, "model_type": "AVMNIST",
                     "audio_encoder": multi["model"]["audio_encoder"],
                     "output_dim": 64, "num_classes": 10}
    training = mono["training"]
    training["num_modalities"] = 1
    del training["encoder_optimizer"], training["modality_specific_params"]
    for split in mono["data"]["datasets"].values():
        split["missing_patterns"]["selected_patterns"] = ["a"]
    del mono["metrics"]["metrics"]["ConfusionMatrix"]
    mono["metrics"]["groups"]["classification"] = ["accuracy", "f1_weighted"]

    scratch = copy.deepcopy(multi)
    scratch["experiment"]["name"] = scratch["model"]["name"] = SCRATCH_NAME
    del scratch["model"]["pretrained_encoders"]
    return {"mono": mono, "pretrained": multi, "scratch": scratch}


def say_card(card: str, msg: str) -> None:
    """A line with a measured number, beside the card's name and power limit."""
    say(f"{msg} [{card}]")


def _run_cli(module, cfg_path: Path, tag: str, out_root: Path, name: str,
             train_samples: int = TRAIN_SAMPLES["train"], extra=()) -> dict:
    """`module.main` on the card through its normal flags (and `extra`);
    what it wrote."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = module.main(["--config", str(cfg_path), "--run_id", "1", *extra])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag}: exit code {rc}")
    metrics = out_root / name / "metrics" / "1"
    epochs = [e for e in json.loads((metrics / "epoch_metrics.json").read_text()) if "epoch" in e]
    # train_monomodal writes its train/validation records to report/, as mmtpu's does
    records = metrics if (metrics / "validation_metrics.json").exists() else metrics / "report"
    validation = json.loads((records / "validation_metrics.json").read_text())
    test = json.loads((metrics / "test_metrics.json").read_text())
    if len(epochs) != TRAIN_EPOCHS or len(validation) != TRAIN_EPOCHS or len(test) != 1:
        raise AssertionError(f"{tag}: {len(epochs)} epochs, {len(validation)} validation "
                             f"records, {len(test)} test records")
    losses = [(e["train"]["loss"], e["validation"]["loss"]) for e in epochs]
    if not all(np.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"{tag}: losses {losses}")
    train_s = epochs[-1]["train"]["timing"]["total_time"]
    return {"seconds": seconds, "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "validation": validation, "test": test[0],
            "samples_per_s": train_samples / train_s, "epoch_s": train_s,
            "models": out_root / name / "models" / "1"}


def _eval_batches(counts: dict, batch: int = TRAIN_BATCH, patterns: int = 3,
                  fused: bool = True) -> dict:
    """Eval steps per split: samples × patterns (ai/a/i) rows in batches of
    `batch`, fused by the device-resident path's factor (the loop's own
    `_auto_eval_factor`), or, with `fused` False, as a streaming loader forms
    them (the stacked engine)."""
    from mmtpu_torch.train.loop import _auto_eval_factor

    steps = {}
    for s in ("validation", "test"):
        rows = counts[s] * patterns
        steps[s] = -(-rows // (batch * (_auto_eval_factor(batch, rows) if fused else 1)))
    return steps


def _accuracies(record: dict) -> dict:
    return {k: round(v, 4) for k, v in record.items() if k.startswith("accuracy")}


def _train_batches(cfg_path: Path, n: int):
    """The config and the first `n` train batches; a split with fewer takes
    its full batches in turn (Kinetics-Sounds has 8, the last padded)."""
    import itertools

    from mmtpu_torch.cli import common

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    batches = list(itertools.islice(cfg.data.build_loader("train", seed=cfg.experiment.seed),
                                    n))
    if len(batches) < n:
        full = [b for b in batches if np.all(b["sample_mask"] > 0)]
        batches = list(itertools.islice(itertools.cycle(full), n))
    return cfg, batches


def _training_setup(cfg, dev):
    """Model, state and train step as `train_multimodal` builds them (the
    model's `clip`, where it has one, as the global-norm clip; the run's
    generator for a model that draws; MM-IMDb's multilabel task)."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = common.init_model(common.build_model_from_config(cfg.model), SEED, dev)
    state = common.make_state(model, cfg.training, clip=cfg.model.kwargs.get("clip"))
    state.generator = common.use_run_generator(model, SEED, dev)
    task = ClassificationTask(
        model=model, loss_group=cfg.training.loss_functions,
        input_keys=[str(m) for m in common.modalities_for_model(cfg.model.model_type)],
        multilabel=cfg.model.model_type.lower() == "mmimdb")
    return model, state, make_train_step(task, state, dev)


def phase_train_profile(dev, card: str, cfg_path: Path, steps: int = 8,
                        tag: str = "[train profile]", batch: int = TRAIN_BATCH) -> dict:
    """A window of fine-tune train steps under the profiler: the device's
    busy share, its kernels per step and the operations that take its time."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3 + steps)
    _, _, step = _training_setup(cfg, dev)
    for b in batches[:3]:  # warm-up: cuDNN plans, allocator
        step(b)
    torch.cuda.synchronize()
    brk = device_breakdown(lambda: [step(b) for b in batches[3:]], top=8)
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"{tag} {steps} train steps (B={batch}): device "
             f"busy {brk['device_ms']:.3f} ms of {brk['profiled_wall_ms']:.3f} ms wall, busy "
             f"share {busy:.3f}; {brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; top device operations "
             f"(name, ms, count) {brk['top']}; top host operations by self CPU time (name, "
             f"ms, count) {brk['top_host']}")
    return {"busy_share": busy, "kernels_per_step": brk["kernel_events"] / steps,
            "device_ms_per_step": brk["device_ms"] / steps}


def _grad_errors(grads: dict, ref: dict) -> dict:
    """Per parameter: max |g - ref| / ‖ref‖."""
    return {n: (grads[n].double() - w.double()).abs().max().item() / max(w.norm().item(), 1e-30)
            for n, w in ref.items()}


def _whole_error(grads: dict, ref: dict) -> float:
    """‖g - ref‖ / ‖ref‖ over all parameters together."""
    import torch

    def flat(t):
        return torch.cat([t[n].double().reshape(-1) for n in sorted(t)])

    return ((flat(grads) - flat(ref)).norm() / flat(ref).norm()).item()


def _worst(errs: dict, k: int = 4) -> list:
    return [(n, float(f"{e:.3e}")) for n, e in sorted(errs.items(), key=lambda t: -t[1])[:k]]


def phase_train_check(dev, cfg_path: Path) -> dict:
    """The fine-tune's first three train steps from the same initial weights
    (dropout 0) on the card and on the CPU, then a step on a batch with a
    zero-padded tail from the CPU's weights on both (the pad-aware
    BatchNorm at full width): the losses in float32. The gradients of
    step 1 and of the padded step are compared in float64 on both devices:
    in float32 either device misses the exact gradient by a few 1e-3 of its
    norm (BatchNorm's backward subtracts nearly equal terms), which would
    hide a fault; in float64 the same code must agree to rounding."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    pad_rows = 28
    padded = {k: v.copy() for k, v in batches[2].items()}
    for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
        padded[k][TRAIN_BATCH - pad_rows:] = 0
    cfg.model.kwargs["dropout"] = 0.0
    cpu = torch.device("cpu")

    def grads_of(model):
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    def float64_step(device, batch, weights=None):
        model, _, step = _training_setup(cfg, device)
        model.double()
        if weights is not None:
            model.load_state_dict(weights)
        with _float64_losses():
            step(_as_float64(batch))
        return grads_of(model)

    models, losses, grads32 = {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        model, _, step = _training_setup(cfg, device)
        losses[label] = []
        for b in batches:
            losses[label].append(float(step(b)["loss"]))
            grads32.setdefault(label, grads_of(model))
        models[label] = (model, step)
    weights = models["cpu"][0].state_dict()  # after step 3
    models["gpu"][0].load_state_dict(weights)
    pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in models.items()}
    grads64 = {label: (float64_step(device, batches[0]), float64_step(device, padded, weights))
               for label, device in (("gpu", dev), ("cpu", cpu))}

    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    say(f"[train check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative differences {rel} (tolerances {TRAIN_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); "
        f"padded tail of {pad_rows} rows, one step from the same weights: GPU "
        f"{pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative {pad_rel:.3e}, tolerance "
        f"{TRAIN_LOSS_RTOL}); TF32 off")
    err32 = _grad_errors(grads32["gpu"], grads32["cpu"])
    exact = grads64["cpu"][0]
    say(f"[train check] step-1 float32 gradients, {len(err32)} parameters: GPU vs CPU worst "
        f"parameter {max(err32.values()):.3e} of its norm "
        f"({sum(e > TRAIN_GRAD_TOL for e in err32.values())} above {TRAIN_GRAD_TOL}), worst "
        f"{_worst(err32)}; whole gradient against the CPU's float64 step: GPU "
        f"{_whole_error(grads32['gpu'], exact):.3e}, CPU {_whole_error(grads32['cpu'], exact):.3e}")
    worst = 0.0
    for i, tag in enumerate(("step 1", "padded step")):
        err64 = _grad_errors(grads64["gpu"][i], grads64["cpu"][i])
        worst = max(worst, max(err64.values()))
        say(f"[train check] {tag} float64 gradients, GPU vs CPU: worst parameter "
            f"{max(err64.values()):.3e} of its norm (tolerance {TRAIN_GRAD64_TOL}), whole "
            f"gradient {_whole_error(grads64['gpu'][i], grads64['cpu'][i]):.3e}; worst "
            f"{_worst(err64)}")
    if rel[0] > TRAIN_LOSS_RTOL or pad_rel > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"train check: GPU and CPU losses differ: {rel}, padded {pad_rel}")
    if worst > TRAIN_GRAD64_TOL:
        raise AssertionError(f"train check: float64 gradients differ by {worst} of their norm")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad64_err": worst}


@contextlib.contextmanager
def _float64_losses():
    """The criteria cast their inputs to float32, as mmtpu's do; the float64
    reference step keeps float64 through the loss."""
    import torch

    from mmtpu_torch.train import losses

    cast = losses._as_float
    losses._as_float = lambda x: torch.as_tensor(x).double()
    try:
        yield
    finally:
        losses._as_float = cast


def _as_float64(batch: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def phase_train(dev, card: str, work: Path) -> dict:
    """Monomodal audio pretraining, the pretrained fine-tune and the same
    fine-tune from scratch, each through its entry point's `main` on the
    card; then a profiled window of train steps and the GPU-vs-CPU check."""
    import torch

    from mmtpu_torch.cli import common, train_monomodal, train_multimodal

    out_root = work / "train"
    paths = {}
    for key, cfg in train_configs(str(out_root)).items():
        paths[key] = work / f"train_{key}.json"
        paths[key].write_text(json.dumps(cfg))

    mono = _run_cli(train_monomodal, paths["mono"], "[train mono]", out_root, MONO_NAME)
    handoff = mono["models"] / "encoder_audio_best.pth"
    if not handoff.exists():
        raise AssertionError(f"train_monomodal wrote no handoff {handoff}")

    loaded = []
    real_load = common.load_pretrained_encoders

    def spy(model, pretrained, logging_cfg):  # the fine-tune's audio encoder as loaded
        out = real_load(model, pretrained, logging_cfg)
        loaded.append({k: v.detach().cpu().clone()
                       for k, v in model.audio_encoder.state_dict().items()})
        return out

    common.load_pretrained_encoders = spy
    try:
        reset_counts()
        pre = _run_cli(train_multimodal, paths["pretrained"], "[train pretrained]", out_root,
                       "Synthetic_AVMNIST_Multimodal_Pretrained")
        launches = read_counts()["fused_mlp"]
        scratch = _run_cli(train_multimodal, paths["scratch"], "[train scratch]", out_root,
                           SCRATCH_NAME)
    finally:
        common.load_pretrained_encoders = real_load

    want = torch.load(handoff, map_location="cpu", weights_only=True)
    if len(loaded) != 2 or set(loaded[0]) != set(want) or not all(
            torch.equal(loaded[0][k], v) for k, v in want.items()):
        raise AssertionError("the fine-tune's audio encoder is not the handoff file's")
    if loaded[1] and all(torch.equal(loaded[1][k], v) for k, v in want.items()):
        raise AssertionError("the scratch fine-tune loaded the handoff")
    per_split = _eval_batches(TRAIN_SAMPLES, TRAIN_BATCH)
    expected = TRAIN_EPOCHS * per_split["validation"] + per_split["test"]
    say(f"[train pretrained] the audio encoder at epoch 0 equals {handoff.name} "
        f"({len(want)} tensors, statistics included)")
    if launches != expected:
        raise AssertionError(f"fused_mlp launched {launches} times in the fine-tune, expected "
                             f"{TRAIN_EPOCHS} × {per_split['validation']} validation + "
                             f"{per_split['test']} test batches = {expected}")
    for tag, run in (("mono", mono), ("pretrained", pre), ("scratch", scratch)):
        say_card(card, f"[train {tag}] {run['seconds']:.2f} s through main (start-up, data "
                 f"and checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s "
                 f"= {run['samples_per_s']:.1f} samples/s (B={TRAIN_BATCH}); peak device "
                 f"memory {run['peak_bytes'] / 2**20:.1f} MiB (max_memory_allocated)")
        for epoch, ((tr, va), rec) in enumerate(zip(run["losses"], run["validation"]), 1):
            say(f"[train {tag}] epoch {epoch}: train loss {tr:.6f}, validation loss {va:.6f}, "
                f"validation accuracy {_accuracies(rec)}")
        say(f"[train {tag}] test {_accuracies(run['test'])}, loss {run['test']['loss']:.6f}")
    say(f"[train pretrained] fused_mlp launches in the fine-tune: {launches} = "
        f"{TRAIN_EPOCHS} × {per_split['validation']} validation + {per_split['test']} test "
        f"batches (none in a train forward)")
    say(f"[train] first-epoch train loss, pretrained vs scratch: "
        f"{pre['losses'][0][0]:.6f} vs {scratch['losses'][0][0]:.6f} (synthetic data; "
        f"no threshold)")

    profile = phase_train_profile(dev, card, paths["pretrained"])
    check = phase_train_check(dev, paths["pretrained"])
    return {"launches": launches, "mono": mono, "pretrained": pre, "scratch": scratch,
            "profile": profile, "check": check, "handoff": handoff}


# The UttFusion training phase: the published widths (mosi_smoke_config) on
# synthetic_mosi at CMU-MOSI's split sizes, the file's batch, epochs, train
# pattern and missing rates.
UTT_SAMPLES = {"train": 1284, "validation": 229, "test": 686}
# phases 15 (c) and 16 (b) train on half CMU-MOSI's train split, for room: 20
# batches of 32 and the same tail of 4 real rows
UTT_HALF_SAMPLES = {"train": 644, "validation": 229, "test": 686}
UTT_BATCH = 32
UTT_PATTERNS = 7  # validation and test: every pattern over {a, t, v}
UTT_NAME = "Synthetic_MOSI_UttFusion"
UTT_LOSS_RTOL = 1e-5  # step 1 and the padded step, GPU (TF32 off) vs CPU
UTT_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1, float32


def utt_train_config(out_root: str, dropout: bool = True, samples: dict = UTT_SAMPLES) -> dict:
    """configs/mosi/synthetic_utt_fusion.yaml at the published widths and
    CMU-MOSI's split sizes (or `samples`); `dropout=False` sets TextCNN's
    and FcClassifier's dropout to 0 (the GPU-vs-CPU check)."""
    cfg = mosi_smoke_config(num_samples=samples["test"], batch_size=UTT_BATCH,
                            out_root=out_root, train_samples=samples["train"],
                            validation_samples=samples["validation"])
    cfg["training"]["epochs"] = TRAIN_EPOCHS
    if not dropout:
        for net in ("netT", "netC"):
            cfg["model"][net]["dropout"] = 0.0
    return cfg


def utt_expected_launches(samples: dict = UTT_SAMPLES) -> dict:
    """`lstm` launches of the run: one per train batch and per fused eval
    step of the device-resident path (train one pattern, the others seven)."""
    train = -(-samples["train"] // UTT_BATCH)
    per = _eval_batches(samples, UTT_BATCH, UTT_PATTERNS)
    return {"train": train, **per,
            "total": TRAIN_EPOCHS * (train + per["validation"]) + per["test"]}


@contextlib.contextmanager
def _clip_norms(norms: list):
    """Record the global gradient norm each train step clips (before the
    clip), as the step computes it."""
    import torch

    from mmtpu_torch.train import step as step_mod

    real = step_mod.clip_by_global_norm

    def spy(params, max_norm):
        params = list(params)
        norms.append(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in params if p.grad is not None])).item())
        return real(params, max_norm)

    step_mod.clip_by_global_norm = spy
    try:
        yield
    finally:
        step_mod.clip_by_global_norm = real


def phase_train_utt_profile(dev, card: str, cfg_path: Path, steps: int = 8) -> dict:
    """A window of UttFusion train steps under the profiler: launches per
    step, the device's busy share, and the `lstm` launches (one per step)."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3 + steps)
    _, _, step = _training_setup(cfg, dev)
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[3:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[train utt profile] {steps} UttFusion train steps (B={UTT_BATCH}, T=50): "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} host launch calls per step; device busy "
             f"{brk['device_ms']:.3f} ms of "
             f"{brk['profiled_wall_ms']:.3f} ms wall, busy share {busy:.3f}; lstm launches "
             f"{counts['lstm']} (device time {brk['own_ms']['lstm']:.4f} ms, "
             f"{brk['own_calls']['lstm']} recorded); top device operations (name, ms, count) "
             f"{brk['top']}; top host operations by self CPU time (name, ms, count) "
             f"{brk['top_host']}")
    if counts["lstm"] != steps:
        raise AssertionError(f"lstm launched {counts['lstm']} times in {steps} train steps")
    return {"busy_share": busy, "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def phase_train_utt_check(dev, cfg_path: Path) -> dict:
    """UttFusion's first three train steps from the same initial weights
    (dropout 0, TF32 off) on the card and on the CPU, where `clip` scales
    the gradients, then the epoch's padded tail (4 real rows of 32) from the
    CPU's weights after step 3 on both: losses, and the step-1 gradients of
    every parameter against its norm in float32 (no BatchNorm on this path;
    the kernel takes float32 only). Both devices' float32 gradients are also
    set against a float64 step on the CPU (plain scan)."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    loader = cfg.data.build_loader("train", seed=cfg.experiment.seed)
    padded = list(loader)[-1]
    real_rows = int(padded["sample_mask"].sum())
    if real_rows != UTT_SAMPLES["train"] % UTT_BATCH:
        raise AssertionError(f"the train split's last batch holds {real_rows} real rows")
    cpu = torch.device("cpu")
    clip = float(cfg.model.kwargs["clip"])

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    models, losses, grads32, norms = {}, {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        norms[label] = []
        with _clip_norms(norms[label]):
            model, _, step = _training_setup(cfg, device)
            losses[label] = []
            for b in batches:
                losses[label].append(float(step(b)["loss"]))
                grads32.setdefault(label, grads_of(model))
            models[label] = (model, step)
    weights = models["cpu"][0].state_dict()  # after step 3
    models["gpu"][0].load_state_dict(weights)
    pad_loss, pad_grads = {}, {}
    for label, (model, step) in models.items():
        pad_loss[label] = float(step(padded)["loss"])
        pad_grads[label] = grads_of(model)

    model64, _, step64 = _training_setup(cfg, cpu)
    model64.double()
    with _float64_losses():
        loss64 = float(step64(_as_float64(batches[0]))["loss"])
    exact = grads_of(model64)

    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    say(f"[train utt check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative differences {rel} (tolerances {UTT_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); float64 CPU step 1 {loss64}; global gradient norms before the "
        f"clip {clip}: GPU {norms['gpu'][:3]}, CPU {norms['cpu'][:3]}; padded tail of "
        f"{UTT_BATCH - real_rows} rows, one step from the same weights: GPU {pad_loss['gpu']}, "
        f"CPU {pad_loss['cpu']} (relative {pad_rel:.3e}, tolerance {UTT_LOSS_RTOL}); TF32 off")
    err32 = _grad_errors(grads32["gpu"], grads32["cpu"])
    pad_err = _grad_errors(pad_grads["gpu"], pad_grads["cpu"])
    against64 = {label: _grad_errors(grads32[label], exact) for label in ("gpu", "cpu")}
    say(f"[train utt check] step-1 float32 gradients after the clip, {len(err32)} parameters: "
        f"GPU vs CPU worst parameter {max(err32.values()):.3e} of its norm (tolerance "
        f"{UTT_GRAD_TOL}; {sum(e > UTT_GRAD_TOL for e in err32.values())} above), whole "
        f"gradient {_whole_error(grads32['gpu'], grads32['cpu']):.3e}, worst {_worst(err32)}; "
        f"against the CPU's float64 step: GPU worst parameter "
        f"{max(against64['gpu'].values()):.3e}, whole {_whole_error(grads32['gpu'], exact):.3e}"
        f"; CPU worst parameter {max(against64['cpu'].values()):.3e}, whole "
        f"{_whole_error(grads32['cpu'], exact):.3e}; padded step GPU vs CPU worst parameter "
        f"{max(pad_err.values()):.3e}, worst {_worst(pad_err)}")
    if not (norms["gpu"][0] > clip and norms["cpu"][0] > clip):
        raise AssertionError(f"step 1's gradient norms {norms['gpu'][0]}, {norms['cpu'][0]} do "
                             f"not exceed clip {clip}: the check would not exercise it")
    if rel[0] > UTT_LOSS_RTOL or pad_rel > UTT_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"train utt check: GPU and CPU losses differ: {rel}, padded "
                             f"{pad_rel}")
    if max(err32.values()) > UTT_GRAD_TOL:
        raise AssertionError(f"train utt check: step-1 gradients differ by "
                             f"{max(err32.values())} of their norm ({_worst(err32)})")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err32.values()),
            "pad_grad_err": max(pad_err.values()), "norm": norms["gpu"][0]}


def phase_train_utt(dev, card: str, work: Path) -> dict:
    """UttFusion training through `train_multimodal.main` on the card: the
    `lstm` kernel in every train and eval forward (counted against the
    loader's batches), the MSA keys of test_metrics.json, then a profiled
    window of train steps and the GPU-vs-CPU check."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "train_utt"
    cfg_path = work / "train_utt.json"
    cfg_path.write_text(json.dumps(utt_train_config(str(out_root))))
    expected = utt_expected_launches()
    reset_counts()
    run = _run_cli(train_multimodal, cfg_path, "[train utt]", out_root, UTT_NAME,
                   train_samples=UTT_SAMPLES["train"])
    counts = read_counts()
    if counts["lstm"] != expected["total"] or counts["fused_mlp"]:
        raise AssertionError(
            f"UttFusion training launched {counts}; expected lstm {TRAIN_EPOCHS} × "
            f"({expected['train']} train + {expected['validation']} validation) + "
            f"{expected['test']} test batches = {expected['total']} and no fused_mlp")
    msa_keys = sorted(k for k in run["test"] if k.startswith("MSA_"))
    bad = [k for k in msa_keys if not np.isfinite(run["test"][k])]
    if len(msa_keys) != 20 * UTT_PATTERNS or bad:
        raise AssertionError(f"test_metrics.json: {len(msa_keys)} MSA keys, not finite {bad}")
    epochs = json.loads((out_root / UTT_NAME / "metrics/1/epoch_metrics.json").read_text())
    if "weighted" not in epochs[0]["validation"]:
        raise AssertionError("epoch_metrics.json: the MSA keys are not nested as mmtpu nests them")
    models = sorted(p.name for p in run["models"].iterdir())
    if not {"best.pth", "last.pth", "epoch_1.pth"} <= set(models):
        raise AssertionError(f"UttFusion run wrote {models}")
    say_card(card, f"[train utt] {run['seconds']:.2f} s through main (start-up, data and "
             f"checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s = "
             f"{run['samples_per_s']:.1f} samples/s (B={UTT_BATCH}, T=50, "
             f"{UTT_SAMPLES['train']} samples); peak device memory "
             f"{run['peak_bytes'] / 2**20:.1f} MiB (max_memory_allocated)")
    say(f"[train utt] lstm launches {counts['lstm']} = {TRAIN_EPOCHS} × ({expected['train']} "
        f"train + {expected['validation']} validation) + {expected['test']} test batches; "
        f"fused_mlp {counts['fused_mlp']}; checkpoints {models}")
    for epoch, ((tr, va), rec) in enumerate(zip(run["losses"], run["validation"]), 1):
        say(f"[train utt] epoch {epoch}: train loss {tr:.6f}, validation loss {va:.6f}, "
            f"validation accuracy {_accuracies(rec)}")
    say(f"[train utt] test_metrics.json: {len(msa_keys)} MSA keys ({msa_keys[:3]} …); ATV "
        f"{ {k: run['test'][k] for k in msa_keys if k.endswith('_ATV')} }; test accuracy "
        f"{_accuracies(run['test'])}")
    profile = phase_train_utt_profile(dev, card, cfg_path)
    check_path = work / "train_utt_check.json"
    check_path.write_text(json.dumps(utt_train_config(str(out_root), dropout=False)))
    check = phase_train_utt_check(dev, check_path)
    return {"launches": counts["lstm"], "run": run, "profile": profile, "check": check}


# The reader phase: the paper's own fine-tune configs
# (configs/avmnist/multimodal_resnet_{pretrained,scratch}.yaml) fed by the
# real AVMNIST reader from `.pt` files this run writes at the train phase's
# sample counts; the cross-validation and --stacked-runs drivers on the
# scratch twin.
PAPER_NAMES = {"pretrained": "AVMNIST_Resnet_Pretrained", "scratch": "AVMNIST_Resnet_Scratch"}
READER_SPLITS = ("train", "validation", "test")
SWEEP_SAMPLES = {"train": 512, "validation": 128, "test": 128}
SPEC_SHAPES = ((32, 94), (32, 100), (28, 94), (36, 120))  # by sample index mod 4


def paper_configs(out_root: str, csvs: dict, handoff: Path) -> dict:
    """Plain-dict twins of multimodal_resnet_pretrained.yaml and
    multimodal_resnet_scratch.yaml: ResNet18 audio (hidden 64), ResNet34
    image (hidden 128), head 192→128→64→10 with dropout 0.5, Adam 5e-4 with
    L2 1e-4 (the pretrained file's encoder groups at 1e-4, L2 2e-4), the
    plateau scheduler, early stopping after 10, batch 128, the files'
    metrics. This run's: the CSVs, the audio handoff (the train phase's
    monomodal run; no image handoff), a TensorBoard path, the output root."""
    import copy

    patterns = {"modalities": {"audio": {"missing_rate": 0.0},
                               "image": {"missing_rate": 0.0}}}

    def split(name, selected, **extra):
        return {"dataset": "AVMNIST", "data_fp": str(csvs[name]),
                "split": {"validation": "valid"}.get(name, name),
                "target_modality": "MULTIMODAL", "batch_size": 128, **extra,
                "missing_patterns": {**patterns, "selected_patterns": selected}}

    metric_names = ("accuracy", "balanced_accuracy", "f1_macro", "f1_weighted",
                    "ConfusionMatrix")
    pretrained = {
        "experiment": {"name": PAPER_NAMES["pretrained"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {
            "name": "AVMNIST_Resnet", "model_type": "AVMNIST",
            "audio_encoder": {"__module_spec__": "resnet18", "in_channels": 1,
                              "hidden_dim": 64},
            "image_encoder": {"__module_spec__": "resnet34", "in_channels": 1,
                              "hidden_dim": 128},
            "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat",
            "pretrained_encoders": {"audio": str(handoff)},
        },
        "training": {
            "epochs": 20, "early_stopping": True, "early_stopping_patience": 10,
            "num_modalities": 2,
            "optimizer": {"name": "Adam",
                          "default_kwargs": {"lr": 0.0005, "weight_decay": 0.0001}},
            "encoder_optimizer": {"name": "Adam",
                                  "default_kwargs": {"lr": 0.0001, "weight_decay": 0.0001}},
            "modality_specific_params": {
                "audio_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
                "image_encoder": {"lr": 0.0001, "weight_decay": 0.0002},
            },
            "scheduler": "plateau",
            "scheduler_kwargs": {"mode": "min", "factor": 0.5, "patience": 5,
                                 "min_lr": 0.00001},
            "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy",
                                                 "loss_args": {}, "weight": 1.0}},
        },
        "data": {"datasets": {
            "train": split("train", ["ai"], shuffle=True),
            "validation": split("validation", ["ai", "a", "i"]),
            "test": split("test", ["ai", "a", "i"]),
        }},
        "metrics": {
            "metrics": {
                "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
                "balanced_accuracy": {"function": "sklearn.metrics.balanced_accuracy_score",
                                      "kwargs": {}},
                "f1_macro": {"function": "sklearn.metrics.f1_score",
                             "kwargs": {"average": "macro", "zero_division": 0}},
                "f1_weighted": {"function": "sklearn.metrics.f1_score",
                                "kwargs": {"average": "weighted", "zero_division": 0}},
                "ConfusionMatrix": {"function": "sklearn.metrics.confusion_matrix",
                                    "kwargs": {"labels": list(range(10))}},
            },
            "groups": {"classification": list(metric_names)},
        },
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "tensorboard_path": f"{out_root}/{{experiment_name}}/tensorboard/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }
    scratch = copy.deepcopy(pretrained)
    scratch["experiment"]["name"] = PAPER_NAMES["scratch"]
    del scratch["model"]["pretrained_encoders"]
    del scratch["training"]["encoder_optimizer"], scratch["training"]["modality_specific_params"]
    return {"pretrained": pretrained, "scratch": scratch}


def write_avmnist_files(root: Path, counts: dict, seed: int = SEED) -> dict:
    """One float32 spectrogram `.pt` (shapes by index: SPEC_SHAPES, so the
    reader crops and pads) and one uint8 (28, 28) image `.pt` per sample,
    both depending on the class, and one CSV per split (audio, image,
    label). Returns the CSV paths and, per split, the arrays the files
    define once the reader has cropped, padded and mapped them."""
    import torch

    from mmtpu_torch.data.avmnist import AUDIO_SHAPE, GIST_EARTH_LUMA, IMAGE_SHAPE

    rng = np.random.default_rng(seed)
    csvs, want = {}, {}
    for name in READER_SPLITS:
        n = counts[name]
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        labels = rng.integers(0, 10, size=n).astype(np.int64)
        audio = np.zeros((n, *AUDIO_SHAPE), np.float32)
        image = np.zeros((n, *IMAGE_SHAPE, 1), np.float32)
        rows = []
        for i, label in enumerate(labels):
            h, w = SPEC_SHAPES[i % len(SPEC_SHAPES)]
            spec = (rng.normal(size=(h, w)) + 0.3 * label).astype(np.float32)
            img = np.clip(rng.normal(20.0 * label + 30.0, 40.0, size=IMAGE_SHAPE),
                          0, 255).astype(np.uint8)
            sp, ip = d / f"spec_{i}.pt", d / f"img_{i}.pt"
            torch.save(torch.from_numpy(spec), sp)
            torch.save(img, ip)
            rows.append(f"{sp},{ip},{label}")
            hh, ww = min(h, AUDIO_SHAPE[0]), min(w, AUDIO_SHAPE[1])
            audio[i, :hh, :ww] = spec[:hh, :ww]
            image[i, :, :, 0] = GIST_EARTH_LUMA[img].astype(np.float32) / 255.0
        csvs[name] = root / f"{name}.csv"
        csvs[name].write_text("audio,image,label\n" + "\n".join(rows) + "\n")
        want[name] = (audio, image, labels)
    return {"csvs": csvs, "want": want}


def phase_reader_build(card: str, data: dict) -> dict:
    """Each split through the reader twice: first from the `.pt` files (the
    `.npy` sidecars written), then from the sidecars, both read in full;
    the arrays byte for byte against what the files define."""
    from mmtpu_torch.data import AVMNIST
    from mmtpu_torch.modalities import Modality

    times = {"files": 0.0, "sidecars": 0.0}
    for name in READER_SPLITS:
        for source in times:
            t0 = time.perf_counter()
            ds = AVMNIST(data["csvs"][name], {"validation": "valid"}.get(name, name))
            got = (np.array(ds.arrays[Modality.AUDIO]), np.array(ds.arrays[Modality.IMAGE]),
                   np.array(ds.labels))
            times[source] += time.perf_counter() - t0
            mapped = isinstance(ds.arrays[Modality.AUDIO], np.memmap)
            if source == "sidecars" and not mapped:
                raise AssertionError(f"[reader] {name}: not served from the .npy sidecars")
            for g, w, what in zip(got, data["want"][name], ("audio", "image", "labels")):
                if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                    raise AssertionError(f"[reader] {name} {what} ({source}): not the bytes "
                                         f"the files define")
    n = sum(len(w[2]) for w in data["want"].values())
    sidecars = sorted(p.name for p in data["csvs"]["train"].parent.glob("train.*.npy"))
    say_card(card, f"[reader] {n} samples ({2 * n} .pt files): arrays from the files "
             f"{times['files']:.3f} s, from the .npy sidecars {times['sidecars']:.3f} s; "
             f"equal byte for byte to what the files define; sidecars {sidecars}")
    return {"files_s": times["files"], "sidecars_s": times["sidecars"], "samples": n}


def phase_train_reader(dev, card: str, work: Path, handoff: Path) -> dict:
    """The paper's pretrained fine-tune fed by the reader (train_avmnist,
    --epochs 2, --profile, TensorBoard on), the scratch twin as a two-fold
    cross-validation (train_multimodal), and the scratch twin as a
    --stacked-runs 2 sweep at SWEEP_SAMPLES; `fused_mlp` counted in each."""
    from mmtpu_torch.cli import common, train_avmnist, train_multimodal

    out_root = work / "reader"
    data = write_avmnist_files(work / "avmnist_data", TRAIN_SAMPLES)
    build = phase_reader_build(card, data)
    cfgs = paper_configs(str(out_root), data["csvs"], handoff)
    paths = {}
    for key, cfg in cfgs.items():
        paths[key] = work / f"paper_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    per_split = _eval_batches(TRAIN_SAMPLES)
    one_run = TRAIN_EPOCHS * per_split["validation"] + per_split["test"]

    reset_counts()
    run = _run_cli(train_avmnist, paths["pretrained"], "[reader fine-tune]", out_root,
                   PAPER_NAMES["pretrained"], extra=("--epochs", str(TRAIN_EPOCHS), "--profile"))
    fine_tune = read_counts()["fused_mlp"]
    if fine_tune != one_run:
        raise AssertionError(f"[reader fine-tune] fused_mlp launched {fine_tune} times, expected "
                             f"{TRAIN_EPOCHS} × {per_split['validation']} validation + "
                             f"{per_split['test']} test batches = {one_run}")
    base = out_root / PAPER_NAMES["pretrained"]
    events = list((base / "tensorboard/1").glob("events.out.tfevents.*"))
    trace = base / "logs/1/profile/trace.json"
    if len(events) != 1 or events[0].stat().st_size == 0:
        raise AssertionError(f"[reader fine-tune] tfevents files {events}")
    if not trace.exists() or trace.stat().st_size == 0:
        raise AssertionError(f"[reader fine-tune] no profiler trace at {trace}")
    if not (base / "metrics/1/1/epoch_metrics.json").exists():
        raise AssertionError("[reader fine-tune] train_avmnist wrote no test entry under 1/")
    say_card(card, f"[reader fine-tune] {run['seconds']:.2f} s through main (under --profile; "
             f"start-up, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
             f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s (B=128, "
             f"{TRAIN_SAMPLES['train']} samples, ResNet18/ResNet34 full width)")
    say(f"[reader fine-tune] fused_mlp launches {fine_tune} = {TRAIN_EPOCHS} × "
        f"{per_split['validation']} validation + {per_split['test']} test batches; tfevents "
        f"{events[0].stat().st_size} bytes; profiler trace {trace.stat().st_size} bytes; "
        f"losses {run['losses']}; test {_accuracies(run['test'])}")

    cv_cfg = dict(cfgs["scratch"])
    cv_cfg["experiment"] = {**cv_cfg["experiment"], "cross_validation": 2}
    paths["cv"] = work / "paper_scratch_cv.json"
    paths["cv"].write_text(json.dumps(cv_cfg))
    reset_counts()
    t0 = time.perf_counter()
    if train_multimodal.main(["--config", str(paths["cv"]), "--run_id", "1",
                              "--epochs", str(TRAIN_EPOCHS)]) != 0:
        raise AssertionError("[reader cv] non-zero exit")
    cv_s = time.perf_counter() - t0
    cv_launches = read_counts()["fused_mlp"]
    metrics = out_root / PAPER_NAMES["scratch"] / "metrics/1"
    agg = {s: json.loads((metrics / f"{s}_metrics_agg.json").read_text())
           for s in READER_SPLITS}
    folds = sorted(p.name for p in metrics.iterdir() if p.is_dir())
    if folds != ["fold_1", "fold_2"] or [len(agg[s]) for s in READER_SPLITS] != [2, 2, 1]:
        raise AssertionError(f"[reader cv] fold dirs {folds}, aggregate lengths "
                             f"{[len(agg[s]) for s in READER_SPLITS]}")
    if not all(np.isfinite(v) for rec in agg["validation"] for v in rec.values()):
        raise AssertionError(f"[reader cv] validation aggregate {agg['validation']}")
    if cv_launches != 2 * one_run:
        raise AssertionError(f"[reader cv] fused_mlp launched {cv_launches} times, expected "
                             f"2 folds × {one_run} = {2 * one_run}")
    say_card(card, f"[reader cv] 2 folds through train_multimodal.main in {cv_s:.2f} s; "
             f"{folds}; fused_mlp launches {cv_launches} = 2 × {one_run}; test aggregate "
             f"{_accuracies(agg['test'][0])}")

    sweep_data = write_avmnist_files(work / "avmnist_sweep", SWEEP_SAMPLES, seed=SEED + 1)
    sweep_cfg = paper_configs(str(out_root / "sweep"), sweep_data["csvs"], handoff)["scratch"]
    paths["sweep"] = work / "paper_scratch_sweep.json"
    paths["sweep"].write_text(json.dumps(sweep_cfg))
    # the stacked engine: one member-axis launch per stacked eval step
    sweep_batches = _eval_batches(SWEEP_SAMPLES, fused=False)
    member = TRAIN_EPOCHS * sweep_batches["validation"] + sweep_batches["test"]
    seeds = []
    real_init = common.init_model

    def spy(model, seed, device):
        seeds.append(int(seed))
        return real_init(model, seed, device)

    common.init_model = spy
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = train_multimodal.main(["--config", str(paths["sweep"]), "--run_id", "1",
                                    "--epochs", str(TRAIN_EPOCHS), "--stacked-runs", "2"])
    finally:
        common.init_model = real_init
    sweep_s = time.perf_counter() - t0
    sweep_launches = read_counts()["fused_mlp"]
    base = out_root / "sweep" / PAPER_NAMES["scratch"]
    trees = {r: sorted(p.name for p in (base / "metrics" / r).iterdir()) for r in ("1", "2")}
    if rc != 0 or seeds != [SEED, SEED + 1] or trees["1"] != trees["2"] or \
            "test_metrics.json" not in trees["2"] or not (base / "models/2/best.pth").exists():
        raise AssertionError(f"[reader sweep] rc {rc}, seeds {seeds}, trees {trees}")
    if sweep_launches != member:
        raise AssertionError(f"[reader sweep] fused_mlp launched {sweep_launches} times, "
                             f"expected one per stacked eval step for both members: "
                             f"{TRAIN_EPOCHS} × {sweep_batches['validation']} + "
                             f"{sweep_batches['test']} = {member}")
    say_card(card, f"[reader sweep] --stacked-runs 2 (the stacked engine) at {SWEEP_SAMPLES} "
             f"in {sweep_s:.2f} s; members run 1 and 2 seeded {seeds}; outputs {trees['2']}; "
             f"fused_mlp launches {sweep_launches} = {TRAIN_EPOCHS} × "
             f"{sweep_batches['validation']} + {sweep_batches['test']} stacked eval steps")
    return {"csvs": data["csvs"], "build": build, "run": run, "launches": fine_tune,
            "cv_launches": cv_launches,
            "sweep_launches": sweep_launches, "cv_s": cv_s, "sweep_s": sweep_s}


# The shipped-weights phase: plain-dict twins of
# configs/avmnist/shipped_wheights_{finetune,finetune_audiofix,scratch}.yaml
# (MNISTAudio and MNISTImage, 32/64 channels, hidden 64; head 128→128→64→10,
# dropout 0.5; the files' Adam groups and plateau scheduler) fed by phase 7's
# `.pt` files, the image encoder of two of them from a reference-layout `.pth`
# this run writes from the seed.
SHIPPED_NAMES = {"finetune": "AVMNIST_ShippedWheights_Finetune",
                 "audiofix": "AVMNIST_ShippedWheights_Finetune_AudioFix",
                 "scratch": "AVMNIST_ShippedWheights_Scratch"}
SHIPPED_HEAD_DIMS = [128, 128, 64, 10]
SHIPPED_CONVS = ((1, 32), (32, 32), (32, 64), (64, 64))
SHIPPED_LOAD_TOL = 1e-4  # the loaded encoder vs a functional replay of the reference module
SHIPPED_OPTIMIZERS = {
    "rmsprop": {"alpha": 0.99, "eps": 1e-8},
    "rmsprop_momentum": {"alpha": 0.99, "eps": 1e-8, "momentum": 0.9},
    "adagrad": {},
    "adadelta": {"rho": 0.9, "eps": 1e-6},
    "adamax": {"betas": [0.9, 0.999]},
    "asgd": {},
    "sparse_adam": {},
}


def shipped_state(seed: int = SEED) -> dict:
    """A reference-layout MNISTImage state dict (the reference's Sequential
    net.0 … net.5: 30 tensors, net.5 3136→64), a plain dict of tensors from
    the seed, built without the port's module."""
    import torch

    g = np.random.default_rng(seed)
    sd = {}
    for slot, convs in ((0, SHIPPED_CONVS[:2]), (2, SHIPPED_CONVS[2:])):
        for which, (cin, cout) in zip(("one", "two"), convs):
            conv, bn = f"net.{slot}.conv_{which}", f"net.{slot}.batch_norm_{which}"
            sd[f"{conv}.weight"] = g.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)
            sd[f"{conv}.bias"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.weight"] = 1 + 0.1 * g.normal(size=cout)
            sd[f"{bn}.bias"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.running_mean"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.running_var"] = g.uniform(0.5, 1.5, size=cout)
            sd[f"{bn}.num_batches_tracked"] = np.asarray(100)
    sd["net.5.weight"] = g.normal(size=(64, 3136)) / 56.0
    sd["net.5.bias"] = 0.1 * g.normal(size=64)
    return {k: torch.from_numpy(np.asarray(v, np.int64 if "num_batches" in k else np.float32))
            for k, v in sd.items()}


def shipped_replay(sd: dict, x_nchw):
    """The reference MNISTImage's eval forward, functionally, from its
    state dict."""
    import torch.nn.functional as F

    def conv_bn(x, conv, bn):
        x = F.conv2d(x, sd[f"{conv}.weight"], sd[f"{conv}.bias"], padding=1)
        x = F.batch_norm(x, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                         sd[f"{bn}.weight"], sd[f"{bn}.bias"], training=False, eps=1e-5)
        return F.relu(x)

    x = conv_bn(x_nchw, "net.0.conv_one", "net.0.batch_norm_one")
    x = F.max_pool2d(conv_bn(x, "net.0.conv_two", "net.0.batch_norm_two"), 2)
    x = conv_bn(x, "net.2.conv_one", "net.2.batch_norm_one")
    x = F.max_pool2d(conv_bn(x, "net.2.conv_two", "net.2.batch_norm_two"), 2)
    return F.linear(x.flatten(1), sd["net.5.weight"], sd["net.5.bias"])


def shipped_configs(out_root: str, csvs: dict, pth: Path) -> dict:
    """Plain-dict twins of shipped_wheights_finetune.yaml ("finetune": the
    image encoder from `pth`, encoder groups at Adam 1e-4 with L2 1e-4),
    _audiofix ("audiofix": the same, the scratch audio encoder back at the
    base 5e-4) and _scratch ("scratch": one Adam group at 5e-4), with this
    run's CSVs and output root; the files' data, metrics and logging
    otherwise (batch 128, ai train, ai/a/i eval, no TensorBoard)."""
    import copy

    base = paper_configs(out_root, csvs, pth)["pretrained"]
    del base["logging"]["tensorboard_path"]
    convs = {name: {"__module_spec__": "conv_block_args", "conv_one_in": i, "conv_one_out": o}
             for name, (i, o) in zip(("conv_block_one_one_args", "conv_block_one_two_args",
                                      "conv_block_two_one_args", "conv_block_two_two_args"),
                                     SHIPPED_CONVS)}
    base["model"] = {
        "name": "AVMNIST_ShippedWheights", "model_type": "AVMNIST",
        "audio_encoder": {"__module_spec__": "mnist_audio", **convs, "hidden_dim": 64},
        "image_encoder": {"__module_spec__": "mnist_image", **copy.deepcopy(convs),
                          "hidden_dim": 64},
        "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat",
        "pretrained_encoders": {"image": str(pth)},
    }
    del base["training"]["modality_specific_params"]
    out = {}
    for key, name in SHIPPED_NAMES.items():
        cfg = copy.deepcopy(base)
        cfg["experiment"]["name"] = name
        if key == "audiofix":
            cfg["training"]["modality_specific_params"] = {"audio_encoder": {"lr": 0.0005}}
        if key == "scratch":
            del cfg["model"]["pretrained_encoders"], cfg["training"]["encoder_optimizer"]
        out[key] = cfg
    return out


def phase_shipped_load(dev, pth: Path, sd: dict) -> dict:
    """The reference-layout file through the port's reader: the encoder's
    tensors byte for byte the file's, and its eval forward on the card
    within SHIPPED_LOAD_TOL of the reference module replayed from the file
    (TF32 off)."""
    import torch

    from mmtpu_torch.checkpoints import load_encoder_checkpoint
    from mmtpu_torch.config.spec import specs_from_dicts

    spec = shipped_configs("unused", {s: "unused" for s in READER_SPLITS}, pth)["finetune"]
    enc = specs_from_dicts(spec["model"]["image_encoder"]).build()
    report = load_encoder_checkpoint(pth, enc)
    got = enc.state_dict()
    if report.kept or report.fallback or set(got) != set(sd) or not all(
            got[k].dtype == v.dtype and torch.equal(got[k], v) for k, v in sd.items()):
        raise AssertionError(f"[shipped load] not the file's tensors: kept {report.kept}, "
                             f"fallback {report.fallback}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=(128, 28, 28, 1))
                         .astype(np.float32))
    enc = enc.to(dev).eval()
    with torch.no_grad():
        ours = enc(x.to(dev)).cpu()
        theirs = shipped_replay({k: v.to(dev) for k, v in sd.items()},
                                x.permute(0, 3, 1, 2).contiguous().to(dev)).cpu()
    err = (ours - theirs).abs().max().item()
    say(f"[shipped load] {pth.name} ({report.format}, model_state_dict with the module. "
        f"prefix): {len(sd)} tensors byte for byte; eval forward on the card vs the "
        f"reference replay, B=128: max |diff| = {err:.3e} (tolerance {SHIPPED_LOAD_TOL})")
    if not torch.isfinite(ours).all() or err > SHIPPED_LOAD_TOL:
        raise AssertionError(f"[shipped load] forward differs from the replay by {err}")
    return {"replay_err": err, "tensors": len(sd)}


def phase_shipped_optimizers(dev, cfg_path: Path) -> dict:
    """Three train steps of the shipped-weights model (image encoder from the
    file, dropout 0, TF32 off) with each optimizer mmtpu builds beyond Adam,
    AdamW and SGD, on the card and on the CPU from the same weights and
    batches: the losses, and no optimizer state left on the host. `lbfgs`
    must fail at its first step on both devices."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.config.optim import OptimizerConfig

    cfg, batches = _train_batches(cfg_path, 3)
    cfg.model.kwargs["dropout"] = 0.0
    cpu = torch.device("cpu")

    def setup(device, name, extra):
        training = cfg.training
        training.optimizer = OptimizerConfig.from_dict(
            {"name": name, "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4, **extra}})
        model, state, step = _training_setup(cfg, device)
        common.load_pretrained_encoders(model, cfg.model.pretrained_encoders, cfg.logging)
        return state, step

    out = {}
    for label, extra in SHIPPED_OPTIMIZERS.items():
        name = label.removesuffix("_momentum")
        losses, host_state = {}, []
        for tag, device in (("gpu", dev), ("cpu", cpu)):
            state, step = setup(device, name, extra)
            losses[tag] = [float(step(b)["loss"]) for b in batches]
            if tag == "gpu":
                host_state = [k for st in state.optimizer.state.values() for k, v in st.items()
                              if isinstance(v, torch.Tensor) and v.device.type != dev.type]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
        say(f"[shipped optimizers] {label}: losses GPU {losses['gpu']}, CPU {losses['cpu']}: "
            f"relative {[float(f'{r:.3e}') for r in rel]} (tolerances {TRAIN_LOSS_RTOL}, then "
            f"{TRAIN_LATER_RTOL}); state tensors off the card {host_state}")
        if rel[0] > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL or host_state:
            raise AssertionError(f"[shipped optimizers] {label}: relative {rel}, state on the "
                                 f"host {host_state}")
        out[label] = rel
    for device in (dev, cpu):
        _, step = setup(device, "lbfgs", {})
        try:
            step(batches[0])
        except NotImplementedError as e:
            if "value function" not in str(e):
                raise
        else:
            raise AssertionError(f"[shipped optimizers] lbfgs took a step on {device}")
    say("[shipped optimizers] lbfgs builds and raises at its first step on the card and on "
        "the CPU, as mmtpu's optax.lbfgs does at its first update")
    return out


def phase_shipped(dev, card: str, work: Path, csvs: dict) -> dict:
    """The shipped-weights flow: the reference-layout `.pth` written and
    checked, the three twins through `train_multimodal.main` on the card
    (2 epochs), predict on the fine-tune's best.pth against the CPU, and the
    optimizers' three train steps against the CPU."""
    import torch

    from mmtpu_torch.cli import common, predict, train_multimodal
    from mmtpu_torch.train.step import make_eval_step

    out_root = work / "shipped"
    out_root.mkdir(parents=True, exist_ok=True)
    sd = shipped_state()
    pth = work / "lenet_image_best.pth"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}}, pth)
    load = phase_shipped_load(dev, pth, sd)

    paths = {}
    for key, cfg in shipped_configs(str(out_root), csvs, pth).items():
        paths[key] = work / f"shipped_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    per_split = _eval_batches(TRAIN_SAMPLES)
    one_run = TRAIN_EPOCHS * per_split["validation"] + per_split["test"]
    # mmtpu's test record: the scalar metrics per pattern (the confusion
    # matrices go to their own files), the loss, the split and the index
    metrics = ("accuracy", "balanced_accuracy", "f1_macro", "f1_weighted")
    want_keys = {"index", "split", "loss", *(f"{m}_{p}" for m in metrics for p in ("AI", "A", "I"))}
    real_load, real_state = common.load_pretrained_encoders, common.make_state
    runs, launches = {}, {}
    for key in SHIPPED_NAMES:
        loaded, groups = [], []

        def spy_load(model, pretrained, logging_cfg):
            mods = real_load(model, pretrained, logging_cfg)
            loaded.append({k: v.detach().cpu().clone()
                           for k, v in model.image_encoder.state_dict().items()})
            return mods

        def spy_state(model, training, clip=None):
            state = real_state(model, training, clip=clip)
            groups.extend((g["label"], g["lr"]) for g in state.optimizer.param_groups)
            return state

        common.load_pretrained_encoders, common.make_state = spy_load, spy_state
        reset_counts()
        try:
            run = _run_cli(train_multimodal, paths[key], f"[shipped {key}]", out_root,
                           SHIPPED_NAMES[key], extra=("--epochs", str(TRAIN_EPOCHS)))
        finally:
            common.load_pretrained_encoders, common.make_state = real_load, real_state
        launches[key] = read_counts()["fused_mlp"]
        from_file = len(loaded) == 1 and all(torch.equal(loaded[0][k], v) for k, v in sd.items())
        if from_file != (key != "scratch"):
            raise AssertionError(f"[shipped {key}] image encoder at epoch 0 from the file: "
                                 f"{from_file}")
        want_groups = {"finetune": [("group_0", 1e-4), ("group_1", 1e-4), ("default", 5e-4)],
                       "audiofix": [("group_0", 5e-4), ("group_1", 1e-4), ("default", 5e-4)],
                       "scratch": [("default", 5e-4)]}[key]
        if groups != want_groups:
            raise AssertionError(f"[shipped {key}] optimizer groups {groups}, expected "
                                 f"{want_groups} (group_0 ^audio_encoder/, group_1 "
                                 "^image_encoder/)")
        if launches[key] != one_run:
            raise AssertionError(f"[shipped {key}] fused_mlp launched {launches[key]} times, "
                                 f"expected {TRAIN_EPOCHS} × {per_split['validation']} "
                                 f"validation + {per_split['test']} test batches = {one_run}")
        if set(run["test"]) != want_keys:
            raise AssertionError(f"[shipped {key}] test_metrics.json keys {sorted(run['test'])}")
        say_card(card, f"[shipped {key}] {run['seconds']:.2f} s through main; epoch "
                 f"{TRAIN_EPOCHS} train {run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} "
                 f"samples/s (B={TRAIN_BATCH}); peak device memory "
                 f"{run['peak_bytes'] / 2**20:.1f} MiB")
        say(f"[shipped {key}] image encoder at epoch 0 from the file: {from_file}; groups "
            f"(label, lr) {groups}; fused_mlp launches {launches[key]} = {TRAIN_EPOCHS} × "
            f"{per_split['validation']} + {per_split['test']}; losses {run['losses']}; test "
            f"{_accuracies(run['test'])}")
        runs[key] = run

    # predict on the fine-tune's best.pth, the card against the CPU
    args = predict.arg_parser().parse_args(
        ["--config", str(paths["finetune"]), "--run_id", "1", "--checkpoint", "best"])
    cfg = common.load_config(args)
    reset_counts()
    task, loader = predict.build_task_and_loader(cfg, args, dev)
    cpu_task, _ = predict.build_task_and_loader(cfg, args, torch.device("cpu"))
    batches = list(loader)
    gpu_step, cpu_step = make_eval_step(task, dev), make_eval_step(cpu_task, torch.device("cpu"))
    worst = 0.0
    for i in (0, 1, len(batches) - 1):
        g_logits, c_logits = gpu_step(batches[i])["logits"].cpu(), cpu_step(batches[i])["logits"]
        if g_logits.shape != (TRAIN_BATCH, 10) or not torch.isfinite(g_logits).all():
            raise AssertionError(f"[shipped predict] batch {i}: logits {tuple(g_logits.shape)}")
        worst = max(worst, (g_logits - c_logits).abs().max().item())
    predict_launches = read_counts()["fused_mlp"]
    say(f"[shipped predict] {SHIPPED_NAMES['finetune']} best.pth: GPU vs CPU logits on 3 of "
        f"{len(batches)} batches, max |diff| = {worst:.3e} (tolerance {CPU_TOL}, TF32 off); "
        f"fused_mlp launches {predict_launches}")
    if worst > CPU_TOL or predict_launches != 3:
        raise AssertionError(f"[shipped predict] logits differ by {worst}; "
                             f"{predict_launches} launches")
    profile = phase_train_profile(dev, card, paths["finetune"], tag="[shipped profile]")
    optimizers = phase_shipped_optimizers(dev, paths["finetune"])
    return {"load": load, "runs": runs, "launches": launches, "predict_err": worst,
            "profile": profile, "optimizers": optimizers}


# Phase 9, C-MAM: plain-dict twins of configs/avmnist/cmam_audio_to_image.yaml
# (its teacher phase 5's scratch fine-tune, its data phase 7's `.pt` files
# through the AVMNIST reader) and of configs/mosi/synthetic_dual_cmam.yaml at
# the published UttFusion widths (its teacher phase 6's model, CMU-MOSI's
# split sizes), each through `train_cmam.main`.
CMAM_NAMES = {"cmam": "AVMNIST_CMAM_A_to_I", "dual": "Synthetic_MOSI_DualCMAM"}
CMAM_SAMPLES = {"cmam": TRAIN_SAMPLES, "dual": UTT_SAMPLES}
CMAM_BATCH = {"cmam": TRAIN_BATCH, "dual": UTT_BATCH}
CMAM_LOSS_RTOL = {"cmam": TRAIN_LOSS_RTOL, "dual": UTT_LOSS_RTOL}  # step 1 and the padded step
CMAM_GRAD_TOL = {"cmam": TRAIN_GRAD64_TOL, "dual": UTT_GRAD_TOL}  # float64 / float32, step 1
CMAM_LOSS64_RTOL = 1e-6  # the AVMNIST C-MAM's float64 losses of steps 1-3, GPU vs CPU
CMAM_TERMS = {"cmam": ["cls_loss", "cosine", "mae", "mse"], "dual": []}


def cmam_configs(out_root: str, csvs: dict, bases: dict, dropout: bool = True) -> dict:
    """The two twins. `bases` names each teacher's best.pth; the config
    names it as the file does, `.../models/{run_id}/best.ckpt`.
    `dropout=False` sets the C-MAMs' dropout to 0 (the GPU-vs-CPU check)."""
    def pretrained(path: Path) -> str:
        return str(path.parent.parent / "{run_id}" / "best.ckpt")

    def logging_(name):
        return {"log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
                "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
                "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
                "save_metric": "loss"}

    audio = {"__module_spec__": "resnet18", "in_channels": 1, "hidden_dim": 64}
    av_patterns = {"modalities": {"audio": {"missing_rate": 0.0},
                                  "image": {"missing_rate": 0.0}},
                   "selected_patterns": ["ai"]}

    def av_split(name, **extra):
        return {"dataset": "AVMNIST", "data_fp": str(csvs[name]),
                "split": {"validation": "valid"}.get(name, name),
                "target_modality": "MULTIMODAL", "batch_size": CMAM_BATCH["cmam"], **extra,
                "missing_patterns": av_patterns}

    cmam = {
        "experiment": {"name": CMAM_NAMES["cmam"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {"name": "AVMNIST", "model_type": "AVMNIST", "audio_encoder": audio,
                  "image_encoder": {"__module_spec__": "resnet34", "in_channels": 1,
                                    "hidden_dim": 128},
                  "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat",
                  "pretrained_path": pretrained(bases["cmam"])},
        "cmam": {"name": "CMAM", "model_type": "CMAM", "target_modality": "image",
                 "load_pretrained_encoder_state_for": ["audio"],
                 "input_encoders": {"__module_spec__": "input_encoders", "audio": audio},
                 "association_network": {"__module_spec__": "association_network",
                                         "input_size": 64, "hidden_size": 256,
                                         "output_size": 128, "batch_norm": True,
                                         "dropout": 0.25 if dropout else 0.0}},
        "target_modality": "image",
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 2,
                     "optimizer": {"name": "Adam",
                                   "default_kwargs": {"lr": 0.001, "weight_decay": 0.0001}},
                     "loss_functions": {"cmam": {
                         "loss_name": "cmam", "weight": 1.0,
                         "loss_kwargs": {"cosine_weight": 1.0, "mae_weight": 1.0,
                                         "mse_weight": 1.0, "cls_weight": 0.005}}}},
        "data": {"datasets": {"train": av_split("train", shuffle=True),
                              "validation": av_split("validation"), "test": av_split("test")}},
        "metrics": {"metrics": {
            "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
            "cosine_sim": {"function": "metrics.cosine_similarity", "kwargs": {}},
            "mse": {"function": "sklearn.metrics.mean_squared_error", "kwargs": {}}},
            "groups": {"classification": ["accuracy"],
                       "reconstruction": ["cosine_sim", "mse"]}},
        "logging": logging_(CMAM_NAMES["cmam"]),
        "monitoring": {"enabled": False},
    }

    def mosi_split(name, n, **extra):
        return {"dataset": "synthetic_mosi", "data_fp": "unused", "split": name,
                "target_modality": "MULTIMODAL", "batch_size": CMAM_BATCH["dual"], **extra,
                "kwargs": {"num_samples": n},
                "missing_patterns": {"modalities": {m: {"missing_rate": 0.0}
                                                    for m in ("audio", "video", "text")},
                                     "selected_patterns": ["atv"]}}

    base = mosi_smoke_config()["model"]
    dual = {
        "experiment": {"name": CMAM_NAMES["dual"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {**base, "pretrained_path": pretrained(bases["dual"])},
        "cmam": {"name": "DualCMAM", "model_type": "dual_cmam", "input_modality": "audio",
                 "target_modality_one": "video", "target_modality_two": "text",
                 "load_pretrained_encoder_state_for": [],
                 "input_encoder": dict(base["netA"]),
                 "shared_encoder_output_size": 64, "decoder_hidden_size": 64,
                 "target_modality_one_embd_size": 64, "target_modality_two_embd_size": 64,
                 "dropout": 0.1 if dropout else 0.0},
        "target_modality": "video",
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {"cmam": {
                         "loss_name": "cmam", "weight": 1.0,
                         "loss_kwargs": {"cosine_weight": 1.0, "mse_weight": 1.0,
                                         "cls_weight": 0.0}}}},
        "data": {"datasets": {
            "train": mosi_split("train", UTT_SAMPLES["train"], shuffle=True),
            "validation": mosi_split("valid", UTT_SAMPLES["validation"]),
            "test": mosi_split("test", UTT_SAMPLES["test"])}},
        "metrics": {"metrics": {"accuracy": {"function": "sklearn.metrics.accuracy_score",
                                             "kwargs": {}}},
                    "groups": {"classification": ["accuracy"], "reconstruction": []}},
        "logging": logging_(CMAM_NAMES["dual"]),
        "monitoring": {"enabled": False},
    }
    return {"cmam": cmam, "dual": dual}


def cmam_batches(kind: str) -> dict:
    """Batches per split as the loaders form them (one pattern each)."""
    n, b = CMAM_SAMPLES[kind], CMAM_BATCH[kind]
    return {s: -(-n[s] // b) for s in ("train", "validation", "test")}


def cmam_expected_lstm(kind: str) -> int:
    """`lstm` launches of a run: none over the AVMNIST teacher; per DualCMAM
    batch three (the teacher's netV for the video target, the student's
    encoder, the teacher's netA under the two reconstructions)."""
    if kind == "cmam":
        return 0
    n = cmam_batches(kind)
    return 3 * (TRAIN_EPOCHS * (n["train"] + n["validation"]) + n["test"])


def _state_hash(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cmam_config(cfg_path: Path):
    from mmtpu_torch.cli import common
    from mmtpu_torch.config.cmam import CMAMConfig

    return common.finalize_config(CMAMConfig.load(cfg_path, run_id=1),
                                  argparse.Namespace(run_id=1))


def _cmam_setup(cfg_path: Path, device):
    """The config, the run as `train_cmam` assembles it, its train step."""
    from mmtpu_torch.cli import train_cmam

    cfg = _cmam_config(cfg_path)
    built = train_cmam.assemble(cfg, device)
    return cfg, built, built.step_builders[0](built.task, built.state, device)


def phase_cmam_profile(dev, card: str, kind: str, cfg_path: Path, steps: int = 8,
                       warmup: int = 3) -> dict:
    """A window of C-MAM train steps under the profiler."""
    import torch

    cfg, built, step = _cmam_setup(cfg_path, dev)
    it = iter(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    batches = [next(it) for _ in range(warmup + steps)]
    for b in batches[:warmup]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[warmup:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[cmam {kind} profile] {steps} train steps (B={CMAM_BATCH[kind]}): "
             f"device {brk['device_ms'] / steps:.3f} ms per step, busy share {busy:.3f}; "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; launches {counts}; "
             f"top device operations (name, ms, count) {brk['top']}; top host operations "
             f"(name, ms, count) {brk['top_host']}")
    want = {"fused_mlp": 0, "lstm": steps * (3 if kind == "dual" else 0)}
    if counts != want:
        raise AssertionError(f"[cmam {kind} profile] launches {counts}, expected {want}")
    return {"busy_share": busy, "device_ms_per_step": brk["device_ms"] / steps,
            "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def phase_cmam_check(dev, kind: str, cfg_path: Path) -> dict:
    """The first three train steps from the same weights (dropout 0, TF32
    off) on the card and on the CPU, then a padded-tail step from the CPU's
    weights after step 3 on both: the losses; the step-1 gradients of every
    C-MAM parameter against its norm, in float64 over the AVMNIST teacher
    (BatchNorm's backward in float32 misses the exact gradient by ~1e-3 of
    its norm on either device) and in float32 over UttFusion (the kernel
    takes float32 only). Over the AVMNIST teacher the losses of steps 2-3
    are judged in float64 too: Adam's first steps amplify the float32
    rounding there to 5.6e-4-1.7e-3 of the loss, depending on the teacher
    that phase 5's (non-deterministic) training wrote, so the float32 ones
    are printed."""
    import torch

    cpu = torch.device("cpu")
    cfg = _cmam_config(cfg_path)
    batches = list(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    if kind == "cmam":
        padded = {k: v.copy() for k, v in batches[2].items()}
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            padded[k][CMAM_BATCH[kind] - 28:] = 0
    else:
        padded = batches[-1]
    real = int(padded["sample_mask"].sum())

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    runs, losses, grads = {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        _, built, step = _cmam_setup(cfg_path, device)
        losses[label] = []
        for b in batches[:3]:
            losses[label].append(float(step(b)["loss"]))
            grads.setdefault(label, grads_of(built.cmam))
        runs[label] = (built, step)
    weights = runs["cpu"][0].cmam.state_dict()
    runs["gpu"][0].cmam.load_state_dict(weights)
    pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in runs.items()}
    losses64 = {}
    if kind == "cmam":
        for label, device in (("gpu", dev), ("cpu", cpu)):
            _, built, step = _cmam_setup(cfg_path, device)
            built.base.double()
            built.cmam.double()
            losses64[label] = []
            with _float64_losses():
                for b in batches[:3]:
                    losses64[label].append(float(step(_as_float64(b))["loss"]))
                    grads.setdefault(f"{label}64", grads_of(built.cmam))
            grads[label] = grads.pop(f"{label}64")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    rel64 = [abs(a - b) / abs(b) for a, b in zip(losses64.get("gpu", []), losses64.get("cpu", []))]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    # a bias that feeds a BatchNorm (the student's fc.bias through fc_0,
    # fc_0.bias) has an exact gradient of 0: its rule is the absolute 1e-12
    zero = {n for n, w in grads["cpu"].items() if w.double().norm().item() < 1e-9}
    err = _grad_errors({n: g for n, g in grads["gpu"].items() if n not in zero},
                       {n: g for n, g in grads["cpu"].items() if n not in zero})
    zero_err = max([(grads["gpu"][n].double() - grads["cpu"][n].double()).abs().max().item()
                    for n in zero], default=0.0)
    precision = "float64" if kind == "cmam" else "float32"
    say(f"[cmam {kind} check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {CMAM_LOSS_RTOL[kind]}, then "
        f"{TRAIN_LATER_RTOL}); padded tail ({real} real rows of {CMAM_BATCH[kind]}) from the "
        f"same weights: GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative "
        f"{pad_rel:.3e}); step-1 {precision} gradients, {len(err)} parameters: worst "
        f"{max(err.values()):.3e} of its norm (tolerance {CMAM_GRAD_TOL[kind]}), whole "
        f"{_whole_error(grads['gpu'], grads['cpu']):.3e}, worst {_worst(err)}; "
        f"{len(zero)} with an exact gradient of 0 {sorted(zero)}: largest |GPU - CPU| "
        f"{zero_err:.3e} (tolerance 1e-12); TF32 off"
        + (f"; float64 losses of steps 1-3, GPU vs CPU relative {rel64} (tolerance "
           f"{CMAM_LOSS64_RTOL}; the float32 ones of steps 2-3 printed only)" if rel64 else ""))
    later_differ = max(rel64) > CMAM_LOSS64_RTOL if rel64 else max(rel[1:]) > TRAIN_LATER_RTOL
    if rel[0] > CMAM_LOSS_RTOL[kind] or pad_rel > CMAM_LOSS_RTOL[kind] or later_differ:
        raise AssertionError(f"[cmam {kind} check] GPU and CPU losses differ: {rel}, padded "
                             f"{pad_rel}, float64 {rel64}")
    if max(err.values()) > CMAM_GRAD_TOL[kind] or zero_err > 1e-12:
        raise AssertionError(f"[cmam {kind} check] step-1 gradients differ by "
                             f"{max(err.values())} of their norm ({_worst(err)}), "
                             f"{zero_err} where the exact gradient is 0")
    return {"loss_rel": rel, "loss64_rel": rel64, "pad_loss_rel": pad_rel,
            "grad_err": max(err.values())}


def _check_cmam_records(kind: str, metrics: Path) -> dict:
    """mmtpu's record keys: the nested groups, loss, and the term columns
    (null on train records) where the step gives terms."""
    base = ["index", "classification", "reconstruction", "loss"]
    recon = {"cmam": ["loss", "cosine_sim_AI", "mse_AI"], "dual": ["loss"]}[kind]
    records = {}
    for split in ("train", "validation", "test"):
        records[split] = json.loads((metrics / f"{split}_metrics.json").read_text())
        tail = ["split"] + (["Epoch"] if split != "test" else [])
        for r in records[split]:
            if list(r) != base + CMAM_TERMS[kind] + tail or list(r["reconstruction"]) != recon:
                raise AssertionError(f"[cmam {kind}] {split} record keys {list(r)}, "
                                     f"reconstruction {list(r['reconstruction'])}")
            terms = [r[k] for k in CMAM_TERMS[kind]]
            if split == "train" and any(t is not None for t in terms):
                raise AssertionError(f"[cmam {kind}] train record carries term means {terms}")
            values = [r["loss"], *r["reconstruction"].values(),
                      *r["classification"].values(), *(terms if split != "train" else [])]
            if not all(np.isfinite(v) for v in values):
                raise AssertionError(f"[cmam {kind}] {split} record {r}")
    return records


def phase_cmam(dev, card: str, work: Path, csvs: dict, bases: dict) -> dict:
    """Both C-MAM kinds through `train_cmam.main` on the card: the teacher
    restored from its file and bitwise unchanged by the run, `fused_mlp` never
    launched, `lstm` three times per DualCMAM batch, mmtpu's record keys;
    then a profiled window and the GPU-vs-CPU check of each."""
    import torch

    from mmtpu_torch.cli import train_cmam
    from mmtpu_torch.train import cmam_step

    out_root = work / "cmam"
    paths, check_paths = {}, {}
    for key, cfg in cmam_configs(str(out_root), csvs, bases).items():
        paths[key] = work / f"cmam_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    for key, cfg in cmam_configs(str(out_root), csvs, bases, dropout=False).items():
        check_paths[key] = work / f"cmam_{key}_check.json"
        check_paths[key].write_text(json.dumps(cfg))

    teachers = []
    real_post = cmam_step.CMAMTask.__post_init__

    def spy(task):  # the teacher as restored, before any step
        real_post(task)
        teachers.append((task.base_model, _state_hash(task.base_model.state_dict())))

    results = {}
    for kind in ("cmam", "dual"):
        teachers.clear()
        cmam_step.CMAMTask.__post_init__ = spy
        reset_counts()
        try:
            run = _run_cli(train_cmam, paths[kind], f"[cmam {kind}]", out_root,
                           CMAM_NAMES[kind], train_samples=CMAM_SAMPLES[kind]["train"])
        finally:
            cmam_step.CMAMTask.__post_init__ = real_post
        counts = read_counts()
        want = {"fused_mlp": 0, "lstm": cmam_expected_lstm(kind)}
        if counts != want:
            raise AssertionError(f"[cmam {kind}] launches {counts}, expected {want}")
        (teacher, before), = teachers
        after = _state_hash(teacher.state_dict())
        in_file = _state_hash(torch.load(bases[kind], map_location="cpu",
                                         weights_only=True)["model"])
        if not before == after == in_file:
            raise AssertionError(f"[cmam {kind}] teacher hash: file {in_file}, restored "
                                 f"{before}, after the run {after}")
        records = _check_cmam_records(kind, out_root / CMAM_NAMES[kind] / "metrics/1")
        n = cmam_batches(kind)
        say_card(card, f"[cmam {kind}] {run['seconds']:.2f} s through train_cmam.main "
                 f"(start-up, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
                 f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s "
                 f"(B={CMAM_BATCH[kind]}, {CMAM_SAMPLES[kind]['train']} samples); peak device "
                 f"memory {run['peak_bytes'] / 2**20:.1f} MiB")
        say(f"[cmam {kind}] launches {counts} (lstm: 3 × ({TRAIN_EPOCHS} × ({n['train']} "
            f"train + {n['validation']} validation) + {n['test']} test batches) for a "
            f"DualCMAM, none over the AVMNIST teacher); teacher state sha256 {after[:16]} "
            f"= its file's, unchanged by the run; losses {run['losses']}; test record "
            f"{ {k: v for k, v in records['test'][0].items() if k != 'index'} }")
        profile = phase_cmam_profile(dev, card, kind, paths[kind])
        check = phase_cmam_check(dev, kind, check_paths[kind])
        results[kind] = {"run": run, "launches": counts, "profile": profile, "check": check}
    return results


def cmam_bases(work: Path) -> dict:
    """Teachers for `--cmam-only`: phase 5's scratch fine-tune and phase 6's
    UttFusion model with seeded weights, each saved as a training
    checkpoint's `best.pth` (the layout those phases write)."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.config import ModelConfig

    bases = {}
    for kind, model_cfg, name, root in (
            ("cmam", train_configs(str(work / "train"))["scratch"]["model"], SCRATCH_NAME,
             work / "train"),
            ("dual", mosi_smoke_config()["model"], UTT_NAME, work / "train_utt")):
        model = common.init_model(common.build_model_from_config(
            ModelConfig.from_dict(model_cfg)), SEED, torch.device("cpu"))
        bases[kind] = root / name / "models/1/best.pth"
        bases[kind].parent.mkdir(parents=True, exist_ok=True)
        torch.save({"model": model.state_dict()}, bases[kind])
    return bases


def say_cmam(card: str, cmam: dict, seconds: float) -> None:
    say_card(card, "[summary] C-MAM: " + "; ".join(
        f"{kind} {r['run']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}), "
        f"{r['run']['seconds']:.2f} s through main, launches {r['launches']}, "
        f"{r['profile']['device_ms_per_step']:.3f} ms of device work per step at busy share "
        f"{r['profile']['busy_share']:.3f}" for kind, r in cmam.items())
        + f"; phase {seconds:.1f} s")


# Phase 10: the MSA families with their own train steps, MMIN and RedCore,
# through `train_multimodal.main` at the published UttFusion widths on
# CMU-MOSI's split sizes.
MSA_NAMES = {"mmin": "Synthetic_MOSI_MMIN_Teacher", "redcore": "Synthetic_MOSI_RedCore"}
MSA_EVAL_PATTERNS = ["atv", "at", "tv"]  # synthetic_mmin_teacher.yaml's evaluation patterns
MSA_LOSS_RTOL = 1e-5  # step 1 and the padded tail, GPU (TF32 off) vs CPU, float32
MSA_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1
MSA_SCHED_TOL = 1e-6  # RedCore's beta, eta after three steps, GPU vs CPU


def msa_configs(out_root: str, teacher: Path, check: bool = False) -> dict:
    """The two twins. MMIN: configs/mosi/synthetic_mmin_teacher.yaml with the
    student at the published UttFusion widths and the AE of the MMIN
    authors' training script (AE_layers 256,128,64, n_blocks 5: latent 320;
    classifier 320→[128,128]→3), the teacher phase 6's UttFusion from its
    best.pth (named by the file's `{run_id}` template), and one departure:
    training on `atv` with audio and video missing at 0.2 (the file's train
    split has no missingness, so the teacher's complement inputs would be
    zeros). RedCore (no config in the repo): Transformer encoders over
    5 / 20 / 768 features, embedding 64, 1 block, 2 heads; the MMIN twin's
    AE; ResidualXE generators 128→64; classifiers 192→[128,128]→3 and
    64→[128]→3 with dropout 0.3. `check=True` sets the classifiers' dropout
    to 0 (the GPU-vs-CPU check, which also neutralises the Transformers'
    dropouts and the VAE sample)."""
    utt = mosi_smoke_config(num_samples=UTT_SAMPLES["test"], batch_size=UTT_BATCH,
                            out_root=out_root, train_samples=UTT_SAMPLES["train"],
                            validation_samples=UTT_SAMPLES["validation"])
    for name in ("validation", "test"):
        utt["data"]["datasets"][name]["missing_patterns"]["selected_patterns"] = (
            MSA_EVAL_PATTERNS)
    base = utt["model"]
    teacher_model = {"__module_spec__": "utt_fusion", **{k: base[k] for k in (
        "netA", "netV", "netT", "netC")},
        "pretrained_path": str(teacher.parent.parent / "{run_id}" / "best.pth")}
    ae = {"__module_spec__": "residual_ae", "layers": [256, 128, 64], "n_blocks": 5,
          "input_dim": 192, "dropout": 0.0}
    common_ = {
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {
                         "cross_entropy": {"loss_name": "cross_entropy", "weight": 1.0},
                         "mse": {"loss_name": "mse", "weight": 0.5},
                         "cycle": {"loss_name": "cycle", "weight": 0.5}}},
        "data": utt["data"],
        "metrics": {"metrics": {"accuracy": {"function": "sklearn.metrics.accuracy_score",
                                             "kwargs": {}}},
                    "groups": {"classification": ["accuracy"]}},
        "logging": utt["logging"], "monitoring": {"enabled": False},
    }

    def fc(width, layers):
        return {"__module_spec__": "fcclassifier", "input_dim": width, "layers": layers,
                "output_dim": 3, "dropout": 0.0 if check else 0.3}

    mmin = {
        "experiment": {"name": MSA_NAMES["mmin"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {"name": "MMIN", "model_type": "mmin",
                  "netA": base["netA"], "netV": base["netV"],
                  "netT": {**base["netT"], "dropout": 0.0}, "netAE": ae,
                  "netC": {**fc(320, [128, 128]), "dropout": 0.0},
                  "pretrained_model": teacher_model},
        **common_,
    }

    def tr(width):
        return {"__module_spec__": "transformer", "width": width, "layers": 1, "heads": 2,
                "embd_width": 64}

    def xe():
        return {"__module_spec__": "residual_xe", "layers": [128, 64], "n_blocks": 3,
                "input_dim": 128, "output_dim": 64, "dropout": 0.0}

    redcore = {
        "experiment": {"name": MSA_NAMES["redcore"], "seed": SEED, "device": "tpu",
                       "is_train": True, "is_test": True},
        "model": {"name": "RedCore", "model_type": "redcore",
                  "netA": tr(5), "netV": tr(20), "netT": tr(768), "netAE": ae,
                  "netC": fc(192, [128, 128]), "netC_A": fc(64, [128]),
                  "netC_V": fc(64, [128]), "netC_T": fc(64, [128]),
                  "netAT_V": xe(), "netAV_T": xe(), "netVT_A": xe()},
        **common_,
    }
    redcore["training"] = {**common_["training"], "loss_functions": {
        k: v for k, v in common_["training"]["loss_functions"].items() if k != "cycle"}}
    return {"mmin": mmin, "redcore": redcore}


def msa_batches() -> dict:
    """Batches per split as the loaders form them: train one pattern, the
    evaluation splits the three patterns' visits."""
    n = len(MSA_EVAL_PATTERNS)
    return {"train": -(-UTT_SAMPLES["train"] // UTT_BATCH),
            **{s: -(-UTT_SAMPLES[s] * n // UTT_BATCH) for s in ("validation", "test")}}


def msa_expected_lstm(kind: str) -> int:
    """`lstm` launches of a run: MMIN's student pair once per forward (G=2)
    and its teacher's netA and netV once each per train batch (G=1): 3 per
    train batch, 1 per evaluation batch; RedCore none."""
    if kind == "redcore":
        return 0
    n = msa_batches()
    return TRAIN_EPOCHS * (3 * n["train"] + n["validation"]) + n["test"]


def _msa_config(cfg_path: Path):
    from mmtpu_torch.cli import common

    return common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))


def _msa_setup(cfg_path: Path, device):
    """The config, the run as `msa_runners` assembles it, its train step."""
    from mmtpu_torch.cli import msa_runners

    cfg = _msa_config(cfg_path)
    built = msa_runners.assemble(cfg, argparse.Namespace(run_id=1), device)
    return cfg, built, built.step_builders[0](built.task, built.state, device)


@contextlib.contextmanager
def _msa_neutralised():
    """The RedCore check's train forward without randomness: the
    Transformers' dropouts pass their input and the VAE sample's ε is 0
    (the two devices' generators draw different numbers)."""
    import torch

    from mmtpu_torch.models import rng

    saved = rng.GeneratorDropout.forward, rng.GeneratorNormal.forward
    rng.GeneratorDropout.forward = lambda self, x: x
    rng.GeneratorNormal.forward = lambda self, like: torch.zeros_like(like)
    try:
        yield
    finally:
        rng.GeneratorDropout.forward, rng.GeneratorNormal.forward = saved


def phase_msa_profile(dev, card: str, kind: str, cfg_path: Path, steps: int = 8,
                      warmup: int = 3) -> dict:
    """A window of train steps under the profiler."""
    import torch

    cfg, _, step = _msa_setup(cfg_path, dev)
    it = iter(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    batches = [next(it) for _ in range(warmup + steps)]
    for b in batches[:warmup]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[warmup:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[msa {kind} profile] {steps} train steps (B={UTT_BATCH}, T=50): device "
             f"{brk['device_ms'] / steps:.3f} ms per step, wall "
             f"{brk['profiled_wall_ms'] / steps:.3f} ms per step, busy share {busy:.3f}; "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; launches {counts}; "
             f"top device operations (name, ms, count) {brk['top']}; top host operations "
             f"(name, ms, count) {brk['top_host']}")
    want = {"fused_mlp": 0, "lstm": steps * (3 if kind == "mmin" else 0)}
    if counts != want:
        raise AssertionError(f"[msa {kind} profile] launches {counts}, expected {want}")
    return {"busy_share": busy, "device_ms_per_step": brk["device_ms"] / steps,
            "wall_ms_per_step": brk["profiled_wall_ms"] / steps,
            "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def phase_msa_check(dev, kind: str, cfg_path: Path) -> dict:
    """The first three train steps from the same initial weights (dropout 0,
    RedCore's randomness neutralised, TF32 off, float32) on the card and on
    the CPU, then the train split's padded tail (4 real rows of 32) from the
    CPU's weights after step 3 on both: the losses, the step-1 gradients of
    every parameter against its norm (a parameter whose exact gradient is 0
    — RedCore's AEs, which no term reads, and its attention key biases —
    within the tolerance of the whole gradient's norm), and RedCore's β and
    η after the three steps."""
    import torch

    cpu = torch.device("cpu")
    cfg = _msa_config(cfg_path)
    batches = list(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    padded = batches[-1]
    real_rows = int(padded["sample_mask"].sum())
    if real_rows != UTT_SAMPLES["train"] % UTT_BATCH:
        raise AssertionError(f"the train split's last batch holds {real_rows} real rows")

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    runs, losses, grads, scheds = {}, {}, {}, {}
    with _msa_neutralised():
        for label, device in (("gpu", dev), ("cpu", cpu)):
            _, built, step = _msa_setup(cfg_path, device)
            losses[label] = []
            for b in batches[:3]:
                losses[label].append(float(step(b)["loss"]))
                grads.setdefault(label, grads_of(built.model))
            if kind == "redcore":
                scheds[label] = {k: getattr(step.sched, k).detach().cpu().double()
                                 for k in ("beta", "eta", "loss_ema", "iter_count")}
            runs[label] = (built, step)
        runs["gpu"][0].model.load_state_dict(runs["cpu"][0].model.state_dict())
        pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    whole = _whole_error(grads["gpu"], grads["cpu"])
    norm_all = float(np.sqrt(sum(float(g.double().square().sum())
                                 for g in grads["cpu"].values())))
    zero = {n for n, w in grads["cpu"].items()
            if n.endswith("attn.key.bias") or w.double().norm().item() <= 1e-9 * norm_all}
    err = _grad_errors({n: g for n, g in grads["gpu"].items() if n not in zero},
                       {n: g for n, g in grads["cpu"].items() if n not in zero})
    zero_err = max([max(grads["gpu"][n].double().abs().max().item(),
                        grads["cpu"][n].double().abs().max().item()) / norm_all
                    for n in zero], default=0.0)
    sched_err = max([((scheds["gpu"][k] - scheds["cpu"][k]).abs().max()
                      / scheds["cpu"][k].abs().max().clamp(min=1e-30)).item()
                     for k in ("beta", "eta") if scheds], default=0.0)
    say(f"[msa {kind} check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {MSA_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); padded tail ({real_rows} real rows of {UTT_BATCH}) from the "
        f"same weights: GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative "
        f"{pad_rel:.3e}); step-1 gradients, {len(err)} parameters: worst "
        f"{max(err.values()):.3e} of its norm (tolerance {MSA_GRAD_TOL}), whole {whole:.3e}, "
        f"worst {_worst(err)}; {len(zero)} with an exact gradient of 0: largest "
        f"{zero_err:.3e} of the whole gradient's norm"
        + (f"; schedule after 3 steps GPU { {k: v.tolist() for k, v in scheds['gpu'].items()} }"
           f", CPU { {k: v.tolist() for k, v in scheds['cpu'].items()} } (beta, eta relative "
           f"{sched_err:.3e}, tolerance {MSA_SCHED_TOL})" if kind == "redcore" else "")
        + "; TF32 off")
    if rel[0] > MSA_LOSS_RTOL or pad_rel > MSA_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[msa {kind} check] GPU and CPU losses differ: {rel}, padded "
                             f"{pad_rel}")
    if max(err.values()) > MSA_GRAD_TOL or zero_err > MSA_GRAD_TOL:
        raise AssertionError(f"[msa {kind} check] step-1 gradients differ by "
                             f"{max(err.values())} of their norm ({_worst(err)}); exact "
                             f"zeros {zero_err}")
    if kind == "redcore" and (sched_err > MSA_SCHED_TOL
                              or int(scheds["gpu"]["iter_count"]) != 3
                              or int(scheds["cpu"]["iter_count"]) != 3):
        raise AssertionError(f"[msa redcore check] schedules differ: {scheds}")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err.values()),
            "zero_grad_err": zero_err, "sched_err": sched_err}


def _run_msa_cli(cfg_path: Path, tag: str, out_root: Path, name: str) -> dict:
    """`train_multimodal.main` on the card; what the MSA driver writes (the
    epoch records and test_metrics.json: mmtpu's driver writes no report)."""
    import torch

    from mmtpu_torch.cli import train_multimodal

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = train_multimodal.main(["--config", str(cfg_path), "--run_id", "1"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag}: exit code {rc}")
    metrics = out_root / name / "metrics" / "1"
    records = json.loads((metrics / "epoch_metrics.json").read_text())
    epochs = [e for e in records if "epoch" in e]
    test = json.loads((metrics / "test_metrics.json").read_text())
    if len(epochs) != TRAIN_EPOCHS or "test" not in records[-1] or len(test) != 1:
        raise AssertionError(f"{tag}: {len(epochs)} epochs, test entry "
                             f"{'test' in records[-1]}, {len(test)} test records")
    losses = [(e["train"]["loss"], e["validation"]["loss"]) for e in epochs]
    accs = [e["validation"]["metrics"] for e in epochs]
    want = {f"accuracy_{p.upper()}" for p in MSA_EVAL_PATTERNS}
    if set(accs[-1]) != want or not all(np.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"{tag}: losses {losses}, validation metrics {accs}")
    train_s = epochs[-1]["train"]["timing"]["total_time"]
    models = sorted(p.name for p in (out_root / name / "models" / "1").iterdir())
    if not {"best.pth", "last.pth", "epoch_1.pth"} <= set(models):
        raise AssertionError(f"{tag}: checkpoints {models}")
    return {"seconds": seconds, "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "validation": accs, "test": test[0], "models": models,
            "samples_per_s": UTT_SAMPLES["train"] / train_s, "epoch_s": train_s}


def phase_msa(dev, card: str, work: Path, teacher: Path) -> dict:
    """MMIN (with phase 6's UttFusion as its frozen teacher) and RedCore
    through `train_multimodal.main` on the card: `lstm` counted against the
    loader's batches (MMIN 3 per train batch, 1 per evaluation batch; RedCore
    none), `fused_mlp` never; the teacher's state hash equal to its file's
    before and after the run; then a profiled window and the GPU-vs-CPU
    check of each."""
    import torch

    from mmtpu_torch.train import mmin_step

    out_root = work / "msa"
    paths, check_paths = {}, {}
    for check, target in ((False, paths), (True, check_paths)):
        for kind, cfg in msa_configs(str(out_root), teacher, check=check).items():
            target[kind] = work / f"msa_{kind}{'_check' if check else ''}.json"
            target[kind].write_text(json.dumps(cfg))
    in_file = _state_hash(torch.load(teacher, map_location="cpu", weights_only=True)["model"])

    teachers = []
    real_post = mmin_step.MMINTask.__post_init__

    def spy(task):  # the teacher as restored, before any step
        real_post(task)
        teachers.append((task.teacher_model, _state_hash(task.teacher_model.state_dict())))

    results = {}
    n = msa_batches()
    for kind in ("mmin", "redcore"):
        teachers.clear()
        mmin_step.MMINTask.__post_init__ = spy
        reset_counts()
        try:
            run = _run_msa_cli(paths[kind], f"[msa {kind}]", out_root, MSA_NAMES[kind])
        finally:
            mmin_step.MMINTask.__post_init__ = real_post
        counts = read_counts()
        want = {"fused_mlp": 0, "lstm": msa_expected_lstm(kind)}
        if counts != want:
            raise AssertionError(f"[msa {kind}] launches {counts}, expected {want} "
                                 f"(batches {n})")
        hashes = ""
        if kind == "mmin":
            (teacher_model, before), = teachers
            after = _state_hash(teacher_model.state_dict())
            if not before == after == in_file:
                raise AssertionError(f"[msa mmin] teacher hash: file {in_file}, restored "
                                     f"{before}, after the run {after}")
            hashes = f"; teacher state sha256 {after[:16]} = its file's, unchanged by the run"
        say_card(card, f"[msa {kind}] {run['seconds']:.2f} s through train_multimodal.main "
                 f"(start-up, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
                 f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s (B={UTT_BATCH}, "
                 f"T=50, {UTT_SAMPLES['train']} samples); peak device memory "
                 f"{run['peak_bytes'] / 2**20:.1f} MiB")
        say(f"[msa {kind}] launches {counts} (lstm expected {want['lstm']}: {TRAIN_EPOCHS} × "
            f"(3 × {n['train']} train + {n['validation']} validation) + {n['test']} test "
            f"batches for MMIN, none for RedCore){hashes}; losses {run['losses']}; "
            f"validation {run['validation']}; test {run['test']}; checkpoints {run['models']}")
        profile = phase_msa_profile(dev, card, kind, paths[kind])
        check = phase_msa_check(dev, kind, check_paths[kind])
        results[kind] = {"run": run, "launches": counts, "profile": profile, "check": check}
    return results


def msa_teacher(work: Path) -> Path:
    """The teacher for `--msa-only`: phase 6's UttFusion model with seeded
    weights, saved as its training checkpoint's best.pth would be."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.config import ModelConfig

    model = common.init_model(common.build_model_from_config(
        ModelConfig.from_dict(mosi_smoke_config()["model"])), SEED, torch.device("cpu"))
    path = work / "train_utt" / UTT_NAME / "models/1/best.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0}, path)
    return path


def say_msa(card: str, msa: dict, seconds: float) -> None:
    say_card(card, "[summary] MSA: " + "; ".join(
        f"{kind} {r['run']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}), "
        f"{r['run']['seconds']:.2f} s through main, launches {r['launches']}, "
        f"{r['profile']['device_ms_per_step']:.3f} ms of device work and "
        f"{r['profile']['wall_ms_per_step']:.3f} ms of wall per step, "
        f"{r['profile']['kernels_per_step']:.1f} device kernels per step, busy share "
        f"{r['profile']['busy_share']:.3f}" for kind, r in msa.items())
        + f"; phase {seconds:.1f} s")


# -- phase 11: Self-MM and MM-IMDb -------------------------------------------------------

SELF_MM_NAMES = {"frozen": "Synthetic_MOSI_SelfMM_Frozen",
                 "finetune": "Synthetic_MOSI_SelfMM_Finetune"}
# BERT-base (MMSA config_regression.json, self_mm on mosi: text_out 768)
BERT_SIZES = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12}
SELF_MM_LSTM_PER_BATCH = 2  # the audio and the video AuViSubNet, one launch each
SELF_MM_LOSS_RTOL = 1e-5  # step 1 and the padded tail, GPU (TF32 off) vs CPU, float32
SELF_MM_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1
SELF_MM_BANK_TOL = 1e-5  # the banks after an epoch-2 step from the same banks and weights
MMIMDB_NAME = "Synthetic_MMIMDb_GMU"
MMIMDB_SAMPLES = {"train": 15552, "validation": 2608, "test": 7799}  # MM-IMDb's splits
MMIMDB_BATCH = 64
MMIMDB_PATTERNS = ["it", "i", "t"]
MMIMDB_PAD_ROWS = 48  # the check's padded tail: 16 real rows of 64
MMIMDB_LOSS_RTOL = 1e-5
MMIMDB_GRAD64_TOL = 1e-6  # float64 gradients, GPU vs CPU, of each parameter's norm
MMIMDB_REQUESTS = 24


def self_mm_config(out_root: str, kind: str, bert_dir: Optional[Path] = None,
                   check: bool = False) -> dict:
    """A plain-dict twin of configs/mosi/synthetic_self_mm.yaml at the widths
    of MMSA's config_regression.json for self_mm on mosi: BERT-base text
    (768 wide, 12 layers, 12 heads), AuViSubNet audio 5→16 and video 20→32
    (1 layer, unidirectional, dropout 0), post dims 128 / 32 / 16 / 32 and
    dropouts 0.1 / 0.0 / 0.1 / 0.0 (fusion / text / audio / video), H 3;
    `need_data_aligned: false`. `frozen`: the file's fresh BERT
    (`pretrained_path: ""`), frozen; `finetune`: `use_finetune: true` from
    the HF directory `bert_dir`. synthetic_mosi in `text_mode: bert` at
    CMU-MOSI's split sizes (the file's 64 / 32 / 32), T = 50, batch 32, 2
    epochs, the file's `atv` evaluation, Adam 1e-3 and `l1`. `check=True`
    sets the post dropouts to 0 (the GPU-vs-CPU check)."""
    def split(name, n, evaluated):
        out = {"dataset": "synthetic_mosi", "data_fp": "unused", "split": name,
               "target_modality": "MULTIMODAL", "batch_size": UTT_BATCH,
               "kwargs": {"num_samples": n, "labels_key": "regression_labels",
                          "text_mode": "bert"}}
        if evaluated:
            out["missing_patterns"] = {
                "modalities": {m: {"missing_rate": 0.0} for m in ("audio", "video", "text")},
                "selected_patterns": ["atv"]}
        else:
            out["shuffle"] = True
        return out

    drop = 0.0 if check else 0.1
    name = SELF_MM_NAMES[kind]
    return {
        "experiment": {"name": name, "seed": SEED, "device": "tpu", "is_train": True,
                       "is_test": True},
        "model": {
            "name": "Self_MM", "model_type": "self-mm",
            "audio_encoder": {"__module_spec__": "auvi_subnet", "in_size": 5,
                              "hidden_size": 16, "out_size": 16, "dropout": 0.0},
            "video_encoder": {"__module_spec__": "auvi_subnet", "in_size": 20,
                              "hidden_size": 32, "out_size": 32, "dropout": 0.0},
            "text_encoder": {"__module_spec__": "bert_text_encoder",
                             "pretrained_path": str(bert_dir) if bert_dir else "",
                             "use_finetune": kind == "finetune", **BERT_SIZES},
            "need_data_aligned": False, "audio_out": 16, "video_out": 32, "text_out": 768,
            "post_fusion_dropout": drop, "post_fusion_dim": 128,
            "post_text_dropout": 0.0, "post_text_dim": 32,
            "post_audio_dropout": drop, "post_audio_dim": 16,
            "post_video_dropout": 0.0, "post_video_dim": 32, "H": 3.0,
        },
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {"l1": {"loss_name": "l1", "weight": 1.0}}},
        "data": {"datasets": {"train": split("train", UTT_SAMPLES["train"], False),
                              "validation": split("valid", UTT_SAMPLES["validation"], True),
                              "test": split("test", UTT_SAMPLES["test"], True)}},
        "metrics": {"metrics": {"mosei": {"function": "metrics.mosei_regression",
                                          "kwargs": {}}},
                    "groups": {"regression": ["mosei"]}},
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def write_bert_dir(root: Path, dropout: float, weights: Optional[Path] = None) -> Path:
    """An HF-style BERT-base directory: `config.json` (the given dropouts)
    and `pytorch_model.bin` under HF's `BertModel` key names, drawn from the
    seed as flax's BERT draws a fresh one; `weights` links an existing
    `.bin` instead of writing it again."""
    import dataclasses

    import torch

    from mmtpu_torch.models import seeded_init
    from mmtpu_torch.models.bert_text import BertConfig, BertModel

    cfg = BertConfig(**BERT_SIZES, hidden_dropout_prob=dropout,
                     attention_probs_dropout_prob=dropout)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(
        {"architectures": ["BertModel"], "model_type": "bert", **dataclasses.asdict(cfg)}))
    if weights is not None:
        (root / "pytorch_model.bin").symlink_to(weights)
    else:
        torch.save(seeded_init(BertModel(cfg), SEED).state_dict(), root / "pytorch_model.bin")
    return root / "pytorch_model.bin"


def self_mm_batches() -> dict:
    return {s: -(-UTT_SAMPLES[s] // UTT_BATCH) for s in ("train", "validation", "test")}


def self_mm_expected_lstm() -> int:
    """Two launches per train, validation and test batch: 2 × (2 × (41 + 8) + 22)."""
    n = self_mm_batches()
    return SELF_MM_LSTM_PER_BATCH * (TRAIN_EPOCHS * (n["train"] + n["validation"]) + n["test"])


def _self_mm_setup(cfg_path: Path, device):
    """The config, Self-MM's train state as its driver assembles it, banks
    prefilled from the train loader, and the train step."""
    from mmtpu_torch.cli import train_self_mm
    from mmtpu_torch.train.managers import ManagerState
    from mmtpu_torch.train.self_mm_step import init_manager_labels, make_self_mm_train_step

    cfg = _msa_config(cfg_path)
    model, task, state = train_self_mm.assemble(cfg, device)
    banks = ManagerState.create(UTT_SAMPLES["train"], train_self_mm.bank_dims(cfg),
                                device=device)
    init_manager_labels(banks, cfg.data.build_loader("train", seed=cfg.experiment.seed))
    return cfg, model, banks, make_self_mm_train_step(task, state, device)


@contextlib.contextmanager
def _captured_banks():
    """The banks `train_self_mm.run` creates, kept for inspection."""
    from mmtpu_torch.train import managers

    made = []
    real = managers.ManagerState.create.__func__

    def spy(cls, *args, **kwargs):
        made.append(real(cls, *args, **kwargs))
        return made[-1]

    managers.ManagerState.create = classmethod(spy)
    try:
        yield made
    finally:
        managers.ManagerState.create = classmethod(real)


def _bank_tensors(banks) -> dict:
    return {f"{field}/{m}": t for field in ("features", "labels", "centers_pos", "centers_neg")
            for m, t in getattr(banks, field).items()}


def phase_self_mm_profile(dev, card: str, kind: str, cfg_path: Path, steps: int = 8,
                          warmup: int = 3) -> dict:
    """A window of epoch-2 train steps (the refinement included) under the profiler."""
    import torch

    cfg, _, banks, step = _self_mm_setup(cfg_path, dev)
    it = iter(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    batches = [next(it) for _ in range(warmup + steps)]
    for b in batches[:warmup]:
        step(banks, b, 1)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(banks, b, 2) for b in batches[warmup:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[self-mm {kind} profile] {steps} epoch-2 train steps (B={UTT_BATCH}, "
             f"T=50, BERT-base): device {brk['device_ms'] / steps:.3f} ms per step, wall "
             f"{brk['profiled_wall_ms'] / steps:.3f} ms per step, busy share {busy:.3f}; "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; launches {counts}; "
             f"top device operations (name, ms, count) {brk['top']}; top host operations "
             f"(name, ms, count) {brk['top_host']}")
    want = {"fused_mlp": 0, "lstm": SELF_MM_LSTM_PER_BATCH * steps}
    if counts != want:
        raise AssertionError(f"[self-mm {kind} profile] launches {counts}, expected {want}")
    return {"busy_share": busy, "device_ms_per_step": brk["device_ms"] / steps,
            "wall_ms_per_step": brk["profiled_wall_ms"] / steps,
            "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps}


def _copy_banks(src, dst) -> None:
    source = _bank_tensors(src)
    for key, t in _bank_tensors(dst).items():
        t.copy_(source[key])


def phase_self_mm_check(dev, kind: str, cfg_path: Path) -> dict:
    """From the same initial weights and banks (post dropouts 0; the
    fine-tuned BERT's dropouts 0 from its check directory; TF32 off;
    float32) on the card and on the CPU: the first three train steps' losses
    and the step-1 gradients of every parameter against its norm (those
    whose exact gradient is 0 — a frozen BERT, the pooler, the attention key
    biases — against the whole gradient's norm); then from the CPU's weights
    and banks after step 3 the train split's padded tail (4 real rows of 32)
    on both; then, again from the same weights and banks, one step at epoch
    2 (the label refinement) and the banks after it."""
    import torch

    cpu = torch.device("cpu")
    cfg = _msa_config(cfg_path)
    batches = list(cfg.data.build_loader("train", seed=cfg.experiment.seed))
    padded = batches[-1]
    real_rows = int(padded["sample_mask"].sum())
    if real_rows != UTT_SAMPLES["train"] % UTT_BATCH:
        raise AssertionError(f"the train split's last batch holds {real_rows} real rows")

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    runs, losses, grads = {}, {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        _, model, banks, step = _self_mm_setup(cfg_path, device)
        losses[label] = []
        for b in batches[:3]:
            losses[label].append(float(step(banks, b, 1)["loss"]))
            grads.setdefault(label, grads_of(model))
        runs[label] = (model, banks, step)

    def sync_gpu_to_cpu():
        runs["gpu"][0].load_state_dict(runs["cpu"][0].state_dict())
        _copy_banks(runs["cpu"][1], runs["gpu"][1])

    sync_gpu_to_cpu()
    pad_loss = {label: float(step(banks, padded, 1)["loss"])
                for label, (_, banks, step) in runs.items()}
    sync_gpu_to_cpu()
    for label, (_, banks, step) in runs.items():
        step(banks, batches[3], 2)
    bank_err = {key: (t.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
                for (key, t), ref in zip(_bank_tensors(runs["gpu"][1]).items(),
                                         _bank_tensors(runs["cpu"][1]).values())}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    norm_all = float(np.sqrt(sum(float(g.double().square().sum()) for g in grads["cpu"].values())))
    zero = {n for n, w in grads["cpu"].items()
            if n.endswith("attention.self.key.bias") or w.double().norm().item() <= 1e-9 * norm_all}
    err = _grad_errors({n: g for n, g in grads["gpu"].items() if n not in zero},
                       {n: g for n, g in grads["cpu"].items() if n not in zero})
    zero_err = max([max(grads["gpu"][n].double().abs().max().item(),
                        grads["cpu"][n].double().abs().max().item()) / norm_all
                    for n in zero], default=0.0)
    bert = [n for n in err if ".bert." in n]
    say(f"[self-mm {kind} check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {SELF_MM_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); padded tail ({real_rows} real rows of {UTT_BATCH}) from the "
        f"same weights and banks: GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative "
        f"{pad_rel:.3e}); step-1 gradients, {len(err)} parameters ({len(bert)} of BERT): "
        f"worst {max(err.values()):.3e} of its norm (tolerance {SELF_MM_GRAD_TOL}), BERT's "
        f"worst {max([err[n] for n in bert], default=0.0):.3e}, worst {_worst(err)}; "
        f"{len(zero)} with an exact gradient of 0: largest {zero_err:.3e} of the whole "
        f"gradient's norm; banks after an epoch-2 step from the same banks and weights: "
        f"worst {max(bank_err.values()):.3e} (tolerance {SELF_MM_BANK_TOL}), worst "
        f"{_worst(bank_err)}; TF32 off")
    if rel[0] > SELF_MM_LOSS_RTOL or pad_rel > SELF_MM_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[self-mm {kind} check] GPU and CPU losses differ: {rel}, "
                             f"padded {pad_rel}")
    if max(err.values()) > SELF_MM_GRAD_TOL or zero_err > SELF_MM_GRAD_TOL:
        raise AssertionError(f"[self-mm {kind} check] step-1 gradients differ by "
                             f"{max(err.values())} of their norm ({_worst(err)}); exact zeros "
                             f"{zero_err}")
    if kind == "finetune" and not bert:
        raise AssertionError("[self-mm finetune check] BERT took no gradient")
    if max(bank_err.values()) > SELF_MM_BANK_TOL:
        raise AssertionError(f"[self-mm {kind} check] banks differ: {_worst(bank_err)}")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad_err": max(err.values()),
            "zero_grad_err": zero_err, "bank_err": max(bank_err.values())}


def phase_self_mm(dev, card: str, work: Path) -> dict:
    """Both Self-MM twins through `train_multimodal.main` on the card: `lstm`
    counted against the loader's batches (2 per train, validation and test
    batch), `fused_mlp` never; the banks after the run finite, on the card,
    the labels within ±H; the checkpoints' size; then a profiled window and
    the GPU-vs-CPU check of each."""
    import torch

    out_root = work / "self_mm"
    weights = write_bert_dir(work / "bert_run", 0.1)
    bert_dirs = {"run": weights.parent,
                 "check": write_bert_dir(work / "bert_check", 0.0, weights).parent}
    n = self_mm_batches()
    results = {}
    for kind in ("frozen", "finetune"):
        paths = {}
        for check in (False, True):
            bert = bert_dirs["check" if check else "run"] if kind == "finetune" else None
            paths[check] = work / f"self_mm_{kind}{'_check' if check else ''}.json"
            paths[check].write_text(json.dumps(self_mm_config(str(out_root), kind, bert,
                                                              check=check)))
        from mmtpu_torch.cli import train_multimodal

        reset_counts()
        with _captured_banks() as made:
            run = _run_cli(train_multimodal, paths[False], f"[self-mm {kind}]", out_root,
                           SELF_MM_NAMES[kind], train_samples=UTT_SAMPLES["train"])
        counts = read_counts()
        want = {"fused_mlp": 0, "lstm": self_mm_expected_lstm()}
        if counts != want:
            raise AssertionError(f"[self-mm {kind}] launches {counts}, expected {want} "
                                 f"(batches {n})")
        (banks,) = made
        tensors = _bank_tensors(banks)
        labels = torch.stack([banks.labels[m] for m in ("audio", "video", "text")])
        if (not all(t.device.type == dev.type and torch.isfinite(t).all()
                    for t in tensors.values())
                or labels.abs().max().item() > 3.0
                or torch.equal(banks.labels["audio"], banks.labels["multimodal"])):
            raise AssertionError(f"[self-mm {kind}] banks after the run: "
                                 f"{ {k: (t.device.type, bool(torch.isfinite(t).all())) for k, t in tensors.items()} }, "
                                 f"largest unimodal label {labels.abs().max().item()}")
        sizes = {p.name: p.stat().st_size for p in run["models"].glob("*.pth")}
        test_atv = {k: round(v, 4) for k, v in sorted(run["test"].items()) if k.endswith("_ATV")}
        say_card(card, f"[self-mm {kind}] {run['seconds']:.2f} s through train_multimodal.main "
                 f"(start-up, BERT, data and checkpoints included); epoch {TRAIN_EPOCHS} train "
                 f"{run['epoch_s']:.3f} s = {run['samples_per_s']:.1f} samples/s (B={UTT_BATCH}, "
                 f"T=50, {UTT_SAMPLES['train']} samples); peak device memory "
                 f"{run['peak_bytes'] / 2**20:.1f} MiB; checkpoints "
                 f"{ {k: round(v / 2**20, 1) for k, v in sorted(sizes.items())} } MiB")
        say(f"[self-mm {kind}] launches {counts} (lstm expected {want['lstm']}: "
            f"{SELF_MM_LSTM_PER_BATCH} × ({TRAIN_EPOCHS} × ({n['train']} train + "
            f"{n['validation']} validation) + {n['test']} test batches)); banks finite on "
            f"the card, unimodal labels within ±3 (largest {labels.abs().max().item():.4f}), "
            f"refined away from the fusion labels; losses {run['losses']}; test {test_atv}")
        shutil.rmtree(out_root / SELF_MM_NAMES[kind], ignore_errors=True)  # ~1.3 GB each
        profile = phase_self_mm_profile(dev, card, kind, paths[False])
        check = phase_self_mm_check(dev, kind, paths[True])
        results[kind] = {"run": run, "launches": counts, "profile": profile, "check": check,
                         "checkpoint_bytes": sizes}
    return results


def mmimdb_config(out_root: str) -> dict:
    """configs/mmimdb/synthetic_gmu.yaml as it is (4096-wide VGG image and
    300-wide word2vec text features, encoders to 512, GMU 512, MaxOut genre
    classifier 512→512→23, Adam 1e-4 with L2 1e-3, `bce_with_logits`, the
    F1 metrics, batch 64, 2 epochs), at MM-IMDb's split sizes (the file's
    256 / 64 / 64)."""
    def split(name, n, patterns, **extra):
        return {"dataset": "synthetic_mmimdb", "data_fp": "unused", "split": name,
                "target_modality": "MULTIMODAL", "batch_size": MMIMDB_BATCH, **extra,
                "kwargs": {"num_samples": n},
                "missing_patterns": {
                    "modalities": {m: {"missing_rate": 0.0} for m in ("text", "image")},
                    "selected_patterns": patterns}}

    f1 = {f"f1_{avg}": {"function": "sklearn.metrics.f1_score",
                        "kwargs": {"average": avg, "zero_division": 0}}
          for avg in ("samples", "macro", "micro")}
    return {
        "experiment": {"name": MMIMDB_NAME, "seed": SEED, "device": "tpu", "is_train": True,
                       "is_test": True},
        "model": {
            "name": "MMIMDb", "model_type": "MMIMDb",
            "image_encoder": {"__module_spec__": "mmimdb_modality_encoder", "input_dim": 4096,
                              "output_dim": 512},
            "text_encoder": {"__module_spec__": "mmimdb_modality_encoder", "input_dim": 300,
                             "output_dim": 512},
            "gated_bimodal_network": {"__module_spec__": "gated_bimodal", "input_one_dim": 512,
                                      "output_one_dim": 512, "input_two_dim": 512,
                                      "output_two_dim": 512},
            "classifier": {"__module_spec__": "mlp_genre_classifier", "input_size": 512,
                           "hidden_size": 512, "output_size": 23},
        },
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False,
                     "early_stopping_patience": 5, "num_modalities": 2,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.0001,
                                                                      "weight_decay": 0.001}},
                     "loss_functions": {"bce": {"loss_name": "bce_with_logits", "loss_args": {},
                                                "weight": 1.0}}},
        "data": {"datasets": {
            "train": split("train", MMIMDB_SAMPLES["train"], ["it"], shuffle=True),
            "validation": split("valid", MMIMDB_SAMPLES["validation"], MMIMDB_PATTERNS),
            "test": split("test", MMIMDB_SAMPLES["test"], MMIMDB_PATTERNS)}},
        "metrics": {"metrics": f1, "groups": {"classification": list(f1)}},
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "loss",
        },
        "monitoring": {"enabled": False},
    }


def mmimdb_batches() -> dict:
    n = len(MMIMDB_PATTERNS)
    return {"train": -(-MMIMDB_SAMPLES["train"] // MMIMDB_BATCH),
            **{s: -(-MMIMDB_SAMPLES[s] * n // MMIMDB_BATCH) for s in ("validation", "test")}}


def phase_mmimdb_check(dev, cfg_path: Path) -> dict:
    """The first three train steps from the same initial weights (the
    classifier's dropout neutralised, TF32 off) on the card and on the CPU,
    then a step on a batch with a zero-padded tail from the CPU's weights:
    float32 losses; the gradients of step 1 and of the padded step in
    float64 on both devices (BatchNorm is on the path: in float32 its
    backward's cancellation would hide a fault, as in the AVMNIST check)."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    padded = {k: v.copy() for k, v in batches[2].items()}
    for k in ("image", "text", "labels", "image_mask", "text_mask", "sample_mask"):
        padded[k][MMIMDB_BATCH - MMIMDB_PAD_ROWS:] = 0
    cpu = torch.device("cpu")

    def grads_of(model):
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    def float64_step(device, batch, weights=None):
        model, _, step = _training_setup(cfg, device)
        model.double()
        if weights is not None:
            model.load_state_dict(weights)
        with _float64_losses():
            step(_as_float64(batch))
        return grads_of(model)

    with _msa_neutralised():
        models, losses = {}, {}
        for label, device in (("gpu", dev), ("cpu", cpu)):
            model, _, step = _training_setup(cfg, device)
            losses[label] = [float(step(b)["loss"]) for b in batches]
            models[label] = (model, step)
        weights = models["cpu"][0].state_dict()
        models["gpu"][0].load_state_dict(weights)
        pad_loss = {label: float(step(padded)["loss"]) for label, (_, step) in models.items()}
        grads64 = {label: (float64_step(device, batches[0]),
                           float64_step(device, padded, weights))
                   for label, device in (("gpu", dev), ("cpu", cpu))}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad_loss["gpu"] - pad_loss["cpu"]) / abs(pad_loss["cpu"])
    worst = 0.0
    for i, tag in enumerate(("step 1", "padded step")):
        err64 = _grad_errors(grads64["gpu"][i], grads64["cpu"][i])
        worst = max(worst, max(err64.values()))
        say(f"[mmimdb check] {tag} float64 gradients, GPU vs CPU: worst parameter "
            f"{max(err64.values()):.3e} of its norm (tolerance {MMIMDB_GRAD64_TOL}), whole "
            f"{_whole_error(grads64['gpu'][i], grads64['cpu'][i]):.3e}; worst {_worst(err64)}")
    say(f"[mmimdb check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative {rel} (tolerances {MMIMDB_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); padded tail "
        f"({MMIMDB_BATCH - MMIMDB_PAD_ROWS} real rows of {MMIMDB_BATCH}) from the same weights: "
        f"GPU {pad_loss['gpu']}, CPU {pad_loss['cpu']} (relative {pad_rel:.3e}); TF32 off")
    if rel[0] > MMIMDB_LOSS_RTOL or pad_rel > MMIMDB_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[mmimdb check] GPU and CPU losses differ: {rel}, padded {pad_rel}")
    if worst > MMIMDB_GRAD64_TOL:
        raise AssertionError(f"[mmimdb check] float64 gradients differ by {worst} of their norm")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad64_err": worst}


def phase_mmimdb_predict(dev, card: str, cfg_path: Path, work: Path) -> dict:
    """`predict` on the run's best checkpoint on the card; the same test
    batches' logits on the CPU (1e-3 absolute, TF32 off) and predictions
    equal wherever |sigmoid − 0.5| is clear of the difference; then the
    server: multilabel answers against the Predictor, a request without
    `text` refused with 400."""
    import torch

    from mmtpu_torch.cli import predict, serve
    from mmtpu_torch.train.step import make_eval_step

    out_json = work / "predictions_mmimdb.json"
    args = predict.arg_parser().parse_args(["--config", str(cfg_path), "--run_id", "1",
                                            "--out", str(out_json)])
    reset_counts()
    t0 = time.perf_counter()
    _, records, summary = predict.run(args)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    visits = MMIMDB_SAMPLES["test"] * len(MMIMDB_PATTERNS)
    if (len(records) != visits or set(summary) != set(MMIMDB_PATTERNS)
            or len(records[0]["pred"]) != 23 or counts != {"fused_mlp": 0, "lstm": 0}):
        raise AssertionError(f"[mmimdb predict] {len(records)} records, patterns {summary}, "
                             f"launches {counts}")
    cfg = _msa_config(cfg_path)
    tasks = {label: predict.build_task_and_loader(cfg, args, device)
             for label, device in (("gpu", dev), ("cpu", torch.device("cpu")))}
    gpu_step = make_eval_step(tasks["gpu"][0], dev)
    cpu_step = make_eval_step(tasks["cpu"][0], torch.device("cpu"))
    worst, checked, clear_rows = 0.0, 0, 0
    for batch in tasks["gpu"][1]:
        g, c = gpu_step(batch), cpu_step(batch)
        gl, cl = g["logits"].cpu(), c["logits"]
        if gl.shape != (MMIMDB_BATCH, 23) or not torch.isfinite(gl).all():
            raise AssertionError(f"[mmimdb predict] logits {tuple(gl.shape)} not finite")
        worst = max(worst, (gl - cl).abs().max().item())
        clear = (torch.sigmoid(cl) - 0.5).abs() > 2 * CPU_TOL
        if not torch.equal(g["preds"].cpu()[clear], c["preds"][clear]):
            raise AssertionError("[mmimdb predict] GPU and CPU predictions differ")
        checked += 1
        clear_rows += int(clear.sum())
    say_card(card, f"[mmimdb predict] {len(records)} visits ({len(MMIMDB_PATTERNS)} patterns "
             f"× {MMIMDB_SAMPLES['test']}) in {seconds:.3f} s through predict.run "
             f"({len(records) / seconds:.1f} visits/s, start-up included); per-pattern exact "
             f"match {summary}; launches {counts}; GPU vs CPU logits over {checked} batches: "
             f"max |diff| {worst:.3e} (tolerance {CPU_TOL}), {clear_rows} clear flags equal")
    if worst > CPU_TOL:
        raise AssertionError(f"[mmimdb predict] GPU vs CPU logits differ by {worst}")

    predictor, meta = serve.load_model(serve.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1"]))
    g = np.random.default_rng(SEED)
    inputs = {"image": g.normal(size=(MMIMDB_REQUESTS, 4096)).astype(np.float32),
              "text": g.normal(size=(MMIMDB_REQUESTS, 300)).astype(np.float32)}
    inputs["text"][::3] = 0.0  # text missing
    inputs["image"][1::3] = 0.0  # image missing
    direct = predictor(**inputs)
    with serve.ServerThread(predictor, meta, max_batch=64, max_wait_ms=5.0) as st:
        got_meta = _get(f"{st.url}/meta")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            answers = list(pool.map(lambda i: _post(f"{st.url}/predict", json.dumps(
                {k: inputs[k][i].tolist() for k in ("image", "text")}).encode()),
                range(MMIMDB_REQUESTS)))
        serve_s = time.perf_counter() - t0
        try:
            _post(f"{st.url}/predict", json.dumps({"image": inputs["image"][0].tolist()}).encode())
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
            e.close()
    if not got_meta.get("multilabel") or refused != 400:
        raise AssertionError(f"[mmimdb serve] /meta {got_meta}, request without text → {refused}")
    serve_err = 0.0
    for i, ans in enumerate(answers):
        serve_err = max(serve_err, float(np.abs(np.asarray(ans["logits"])
                                                - direct["logits"][i]).max()))
        clear = np.abs(direct["probs"][i] - 0.5) > 2 * SERVE_TOL
        if len(ans["preds"]) != 23 or not np.array_equal(np.asarray(ans["preds"])[clear],
                                                         direct["preds"][i][clear]):
            raise AssertionError(f"[mmimdb serve] row {i}: preds {ans['preds']}")
    say_card(card, f"[mmimdb serve] {MMIMDB_REQUESTS} concurrent /predict (8 clients) in "
             f"{serve_s:.3f} s; multilabel answers vs the Predictor: max |logit diff| "
             f"{serve_err:.3e} (tolerance {SERVE_TOL}); /meta multilabel "
             f"{got_meta['multilabel']}; request without 'text' → 400")
    if serve_err > SERVE_TOL:
        raise AssertionError(f"[mmimdb serve] answers differ from the Predictor by {serve_err}")
    return {"visits_per_s": len(records) / seconds, "logit_err": worst,
            "serve_err": serve_err, "launches": counts}


def phase_mmimdb(dev, card: str, work: Path) -> dict:
    """MM-IMDb through `train_multimodal.main` at the published GMU widths:
    no launch of either kernel; mmtpu's test keys; the loaders' batch counts;
    predict and serve; a profiled window; the GPU-vs-CPU check."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "mmimdb"
    cfg_path = work / "mmimdb.json"
    cfg_path.write_text(json.dumps(mmimdb_config(str(out_root))))
    cfg = _msa_config(cfg_path)
    n = mmimdb_batches()
    got = {s: len(cfg.data.build_loader(s, seed=SEED)) for s in n}
    if got != n:
        raise AssertionError(f"[mmimdb] batches {got}, expected {n}")
    reset_counts()
    run = _run_cli(train_multimodal, cfg_path, "[mmimdb]", out_root, MMIMDB_NAME,
                   train_samples=MMIMDB_SAMPLES["train"])
    counts = read_counts()
    want_keys = {f"f1_{avg}_{p.upper()}" for avg in ("samples", "macro", "micro")
                 for p in MMIMDB_PATTERNS}
    if counts != {"fused_mlp": 0, "lstm": 0} or not want_keys <= set(run["test"]):
        raise AssertionError(f"[mmimdb] launches {counts}, test keys {sorted(run['test'])}")
    say_card(card, f"[mmimdb] {run['seconds']:.2f} s through train_multimodal.main (start-up, "
             f"data and checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s "
             f"= {run['samples_per_s']:.1f} samples/s (B={MMIMDB_BATCH}, "
             f"{MMIMDB_SAMPLES['train']} samples); peak device memory "
             f"{run['peak_bytes'] / 2**20:.1f} MiB")
    say(f"[mmimdb] batches {got}; launches {counts}; losses {run['losses']}; test "
        f"{ {k: round(v, 4) for k, v in sorted(run['test'].items()) if k.startswith('f1_')} }")
    pred = phase_mmimdb_predict(dev, card, cfg_path, work)
    profile = phase_train_profile(dev, card, cfg_path, tag="[mmimdb profile]",
                                  batch=MMIMDB_BATCH)
    check = phase_mmimdb_check(dev, cfg_path)
    return {"run": run, "launches": counts, "predict": pred, "profile": profile,
            "check": check}


def say_phase11(card: str, self_mm: Optional[dict], mmimdb: Optional[dict],
                seconds: float) -> None:
    parts = []
    for kind, r in (self_mm or {}).items():
        parts.append(f"Self-MM {kind} {r['run']['samples_per_s']:.1f} train samples/s (epoch "
                     f"{TRAIN_EPOCHS}), {r['run']['seconds']:.2f} s through main, launches "
                     f"{r['launches']}, {r['profile']['device_ms_per_step']:.3f} ms of device "
                     f"work and {r['profile']['wall_ms_per_step']:.3f} ms of wall per step, busy "
                     f"share {r['profile']['busy_share']:.3f}")
    if mmimdb:
        parts.append(f"MM-IMDb {mmimdb['run']['samples_per_s']:.1f} train samples/s (epoch "
                     f"{TRAIN_EPOCHS}), {mmimdb['run']['seconds']:.2f} s through main, launches "
                     f"{mmimdb['launches']}, predict {mmimdb['predict']['visits_per_s']:.1f} "
                     f"visits/s, {mmimdb['profile']['device_ms_per_step']:.3f} ms of device "
                     f"work per step, busy share {mmimdb['profile']['busy_share']:.3f}")
    say_card(card, "[summary] phase 11: " + "; ".join(parts) + f"; phase {seconds:.1f} s")


# Phase 12: the serving export (predict --export, serve --artifact,
# train_cmam --export-serving) with both kernels as operators inside the
# artifacts; Kinetics-Sounds at mmtpu's class defaults on the repository's
# clips; the monomodal pretrainings of encoders without `hidden_dim`.
EXPORT_TOL = 1e-5  # an artifact vs the in-process forward on the card, TF32 off
DUAL_EXPORT_LSTM_PER_BATCH = 2  # the C-MAM's LSTM encoder, the base's netA
KS_NAME = "KineticsSounds_Baseline"
KS_SAMPLES = {"train": 468, "validation": 156, "test": 156}  # DATA/kinetics-sounds
KS_BATCH = 64
KS_PATTERNS = ["av", "a", "v"]
KS_CONVS = ((1, 16), (16, 32), (32, 64))  # the flatten at (128, 128): 64 × 4 × 2 = 512
KS_TAIL_ROWS = 20  # real rows of the last train batch: 468 = 7 × 64 + 20
KS_REQUESTS = 24
KS_PATH = {"label": "KineticsSounds", "kernel": None, "classes": 26,
           "patterns": set(KS_PATTERNS), "keys": ["audio", "video"]}
MONO_NAMES = {"text": "Synthetic_MOSI_Text_Encoder", "audio": "Synthetic_MOSI_Audio_Encoder",
              "mmimdb": "Synthetic_MMIMDb_Text_Encoder"}
FINETUNE_NAMES = {"utt": "Synthetic_MOSI_UttFusion_Pretrained",
                  "gmu": "Synthetic_MMIMDb_GMU_Pretrained"}


def _checkpoint(cfg_path: Path, which: str) -> Path:
    """The run's best | last | epoch_K checkpoint path, as predict resolves it."""
    from mmtpu_torch.cli import common

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    return common.checkpoint_path(cfg, which)


def _masked_batches(loader, keys):
    """Each batch's inputs with its pattern's missing modality zeroed, as a
    caller of an artifact sends them (the eval step multiplies the same
    masks in on the device)."""
    out = []
    for batch in loader:
        ins = {}
        for k in keys:
            x = np.asarray(batch[k])
            mask = batch.get(f"{k}_mask")
            ins[k] = x if mask is None else (
                x * np.asarray(mask, x.dtype).reshape(-1, *([1] * (x.ndim - 1))))
        out.append(ins)
    return out


def _serving_pass(fn, batches) -> tuple:
    """Every batch through `fn` (numpy in, numpy out, as a user calls a
    ServedModel or a Predictor); (outputs by batch, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(**b) for b in batches]
    return outs, time.perf_counter() - t0


def _max_diff(a: list, b: list, keys=None) -> float:
    return max(float(np.abs(np.asarray(x[k], np.float64) - np.asarray(y[k], np.float64)).max())
               for x, y in zip(a, b) for k in (keys or x))


def _timed_export():
    """Patches `serving.export_task` / `export_cmam` to record how long each
    export takes; yields the list of seconds."""
    from mmtpu_torch import serving

    times = []
    real = {name: getattr(serving, name) for name in ("export_task", "export_cmam")}

    def timed(fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times.append(time.perf_counter() - t0)
            return out
        return wrapper

    @contextlib.contextmanager
    def ctx():
        for name, fn in real.items():
            setattr(serving, name, timed(fn))
        try:
            yield times
        finally:
            for name, fn in real.items():
                setattr(serving, name, fn)

    return ctx()


def phase_export_task(dev, card: str, work: Path, cfg_path: Path, ckpt: Path,
                      path: dict) -> dict:
    """`predict --export` on the run's checkpoint, then the artifact on the
    card over the same visits: the kernel exactly once per batch inside it,
    every output within EXPORT_TOL of the Predictor's; visits/s of both."""
    from mmtpu_torch.cli import common, predict
    from mmtpu_torch.serving import Predictor, load_artifact

    label, kernel, keys = path["label"], path["kernel"], path["keys"]
    tag = f"[export {label}]"
    art = work / f"{label}.mmx"
    args = predict.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1", "--checkpoint", str(ckpt),
         "--out", str(work / f"export_{label}.json"), "--export", str(art)])
    reset_counts()
    with _timed_export() as times:
        _, records, _ = predict.run(args)
    cfg = common.load_config(args)
    task, loader = predict.build_task_and_loader(cfg, args, dev)
    batches = _masked_batches(loader, keys)
    if read_counts()[kernel] != len(batches):
        raise AssertionError(f"{tag} predict launched {read_counts()} in {len(batches)} "
                             "batches")
    t0 = time.perf_counter()
    served = load_artifact(art, dev)
    load_s = time.perf_counter() - t0
    graph_ops = {name: sum(str(n.target).startswith(f"mmtpu.{name}")
                           for n in served.program.graph.nodes) for name in ("fused_mlp", "lstm")}
    predictor = Predictor(task, dev)
    for fn in (served, predictor):  # warm-up: cuDNN plans, the allocator
        fn(**batches[0])
    reset_counts()
    art_out, art_s = _serving_pass(served, batches)
    launches = read_counts()
    pred_out, pred_s = _serving_pass(predictor, batches)
    err = _max_diff(art_out, pred_out)
    want = {k: (len(batches) if k == kernel else 0) for k in launches}
    say_card(card, f"{tag} predict --export: {len(records)} visits, artifact {art.name} "
             f"{art.stat().st_size / 2**20:.1f} MiB written in {times[-1]:.2f} s (traced on a copy "
             f"of the model on the CPU), loaded onto the card in {load_s:.2f} s; its "
             f"graph holds {graph_ops}")
    say_card(card, f"{tag} {len(records)} visits in {len(batches)} batches: artifact "
             f"{art_s:.3f} s ({len(records) / art_s:.1f} visits/s), Predictor {pred_s:.3f} s "
             f"({len(records) / pred_s:.1f} visits/s); launches inside the artifact "
             f"{launches} (expected {want}); max |artifact - Predictor| over logits, "
             f"probs, preds {err:.3e} (tolerance {EXPORT_TOL}, TF32 off)")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    if err > EXPORT_TOL or not all(np.isfinite(o["logits"]).all() for o in art_out):
        raise AssertionError(f"{tag} the artifact differs from the Predictor by {err}")
    return {"artifact": art, "launches": launches[kernel], "batches": batches,
            "outputs": art_out, "visits": len(records), "visits_per_s": len(records) / art_s,
            "predictor_visits_per_s": len(records) / pred_s, "err": err,
            "export_s": times[-1], "graph_ops": graph_ops}


def phase_export_cpu(card: str, av: dict) -> float:
    """The AVMNIST artifact loaded on the CPU against the card: the first
    batch and the padded tail, predict's limit (1e-3)."""
    import torch

    from mmtpu_torch.serving import load_artifact

    served = load_artifact(av["artifact"], "cpu")
    if served.device != torch.device("cpu"):
        raise AssertionError(f"[export cpu] loaded onto {served.device}")
    picks = [0, len(av["batches"]) - 1]
    t0 = time.perf_counter()
    outs = [served(**av["batches"][i]) for i in picks]
    seconds = time.perf_counter() - t0
    err = _max_diff(outs, [av["outputs"][i] for i in picks], ["logits"])
    say_card(card, f"[export cpu] the AVMNIST artifact on the CPU, batches {picks}: "
             f"{seconds:.2f} s; max |CPU - card| logits {err:.3e} (tolerance {CPU_TOL})")
    if err > CPU_TOL:
        raise AssertionError(f"[export cpu] CPU and card differ by {err}")
    return err


def phase_export_dual(dev, card: str, work: Path, teacher: Path) -> dict:
    """Phase 9's DualCMAM twin through `train_cmam.main --export-serving`
    (one epoch): the artifact on the card over the test split's audio
    against the C-MAM serving function called eagerly on the best
    checkpoint, every output within EXPORT_TOL; `lstm` exactly
    DUAL_EXPORT_LSTM_PER_BATCH per batch inside it."""
    import torch

    from mmtpu_torch.cli import train_cmam
    from mmtpu_torch.serving import load_artifact, make_cmam_serving_fn

    out_root = work / "export_dual"
    cfg = cmam_configs(str(out_root), {s: "unused" for s in ("train", "validation", "test")},
                       {"cmam": teacher, "dual": teacher})["dual"]
    cfg["training"]["epochs"] = 1
    cfg_path = work / "export_dual.json"
    cfg_path.write_text(json.dumps(cfg))
    art = work / "DualCMAM.mmx"
    t0 = time.perf_counter()
    with _timed_export() as times:
        rc = train_cmam.main(["--config", str(cfg_path), "--run_id", "1",
                              "--export-serving", str(art)])
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[export dual] train_cmam exit code {rc}")
    served = load_artifact(art, dev)
    meta = served.meta
    if (meta["task_type"], meta["imputes"], meta["input_keys"], meta["model"]) != (
            "cmam", ["video", "text"], ["audio"], "DualCMAM"):
        raise AssertionError(f"[export dual] meta {meta}")
    ccfg = _cmam_config(cfg_path)
    built = train_cmam.assemble(ccfg, dev)
    best = torch.load(out_root / CMAM_NAMES["dual"] / "models/1/best.pth", map_location=dev,
                      weights_only=False)
    built.cmam.load_state_dict(best["model"])
    eager = make_cmam_serving_fn(built.task)

    def reference(**ins):
        with torch.inference_mode():
            out = eager(torch.from_numpy(ins["audio"]).to(dev))
        return {k: v.cpu().numpy() for k, v in out.items()}

    batches = _masked_batches(ccfg.data.build_loader("test", seed=SEED), ["audio"])
    for fn in (served, reference):
        fn(**batches[0])
    reset_counts()
    art_out, art_s = _serving_pass(served, batches)
    launches = read_counts()
    ref_out, ref_s = _serving_pass(reference, batches)
    err = _max_diff(art_out, ref_out)
    want = {"fused_mlp": 0, "lstm": DUAL_EXPORT_LSTM_PER_BATCH * len(batches)}
    visits = UTT_SAMPLES["test"]
    say_card(card, f"[export dual] train_cmam --export-serving: {run_s:.2f} s through main "
             f"(1 epoch), export {times[-1]:.2f} s, {art.stat().st_size / 2**20:.1f} MiB; "
             f"meta imputes {meta['imputes']} from {meta['input_keys']}; {visits} test visits "
             f"in {len(batches)} batches: artifact {len(batches) / art_s * CMAM_BATCH['dual']:.1f}"
             f" rows/s ({art_s:.3f} s), eager C-MAM forward {ref_s:.3f} s; launches inside the "
             f"artifact {launches} (expected {want}: {DUAL_EXPORT_LSTM_PER_BATCH} per batch); "
             f"max |artifact - eager| over {sorted(art_out[0])} {err:.3e} (tolerance "
             f"{EXPORT_TOL})")
    if launches != want:
        raise AssertionError(f"[export dual] launches {launches}, expected {want}")
    if err > EXPORT_TOL:
        raise AssertionError(f"[export dual] the artifact differs from the eager forward by "
                             f"{err}")
    return {"launches": launches["lstm"], "batches": len(batches), "err": err,
            "visits_per_s": visits / art_s, "eager_visits_per_s": visits / ref_s}


def phase_export(dev, card: str, work: Path, av_cfg: Path, av_ckpt: Path, mosi_cfg: Path,
                 mosi_ckpt: Path, dual_teacher: Path, av_serve_rate: Optional[float]) -> dict:
    """Phase 12 (a): both classification artifacts, the AVMNIST one on the
    CPU and behind `serve --artifact`, and the DualCMAM artifact."""
    from mmtpu_torch.cli import serve

    export_dir = work / "export"
    export_dir.mkdir(exist_ok=True)
    av = phase_export_task(dev, card, export_dir, av_cfg, av_ckpt, AVMNIST_PATH)
    mosi = phase_export_task(dev, card, export_dir, mosi_cfg, mosi_ckpt, MOSI_PATH)
    cpu_err = phase_export_cpu(card, av)
    reference, _ = serve.load_model(serve.arg_parser().parse_args(
        ["--config", str(av_cfg), "--run_id", "1", "--checkpoint", str(av_ckpt)]))
    srv = phase_serve(av_cfg, AVMNIST_PATH, avmnist_requests(),
                      argv=["--artifact", str(av["artifact"])], reference=reference,
                      tol=EXPORT_TOL)
    say_card(card, f"[export serve] serve --artifact {srv['requests_per_s']:.1f} requests/s "
             f"(16 clients); phase 4's serve of the same model from its config "
             + (f"{av_serve_rate:.1f} requests/s" if av_serve_rate else "not run")
             + f"; no-model ceiling {srv['null_requests_per_s']:.1f}")
    dual = phase_export_dual(dev, card, work, dual_teacher)
    return {"avmnist": av, "utt": mosi, "cpu_err": cpu_err, "serve": srv, "dual": dual}


def write_ks_csvs(root: Path) -> dict:
    """The repository's Kinetics-Sounds split CSVs with their tensor paths
    resolved against this checkout (the files name another checkout's)."""
    import csv

    src = ROOT / "DATA" / "kinetics-sounds"
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    for split in KS_SAMPLES:
        with open(src / f"{split}.csv", newline="") as f:
            rows = list(csv.reader(f))
        path = root / f"{split}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(rows[0])
            for audio, video, label in rows[1:]:
                w.writerow([src / "tensors" / Path(audio).name,
                            src / "tensors" / Path(video).name, label])
        if len(rows) - 1 != KS_SAMPLES[split]:
            raise AssertionError(f"[ks] {split}.csv has {len(rows) - 1} rows")
        out[split] = path
    return out


def ks_config(out_root: str, csvs: dict, dropout: bool = True) -> dict:
    """Kinetics-Sounds at mmtpu's class defaults (the audio encoder's
    fc_one_input_size 512 → 64 → 64 with dropouts 0.554 / 0.336, the video
    MLP 400 → 256 → 128 with 0.56, fusion 192 → 128 → 64 → 26 with 0.38),
    ConvBlocks 1→16, 16→32, 32→64 (so a 128 × 128 spectrogram flattens to
    exactly 512), batch 64, Adam 1e-3, 2 epochs, train `av`, evaluation over
    `av`, `a`, `v`; the split CSVs name the repository's clips, whose label
    column is `class`. `dropout=False` sets every rate to 0 (the GPU-vs-CPU
    check)."""
    def block(i, o):
        return {"__module_spec__": "conv_block",
                "conv_block_one_args": {"__module_spec__": "conv_block_args",
                                        "conv_one_in": i, "conv_one_out": o},
                "conv_block_two_args": {"__module_spec__": "conv_block_args",
                                        "conv_one_in": o, "conv_one_out": o}}

    def rate(p):
        return p if dropout else 0.0

    def split(name, patterns, **extra):
        return {"dataset": "kinetics_sounds", "data_fp": str(csvs[name]),
                "split": {"validation": "valid"}.get(name, name),
                "target_modality": "MULTIMODAL", "batch_size": KS_BATCH, **extra,
                "kwargs": {"labels_key": "class"},
                "missing_patterns": {
                    "modalities": {m: {"missing_rate": 0.0} for m in ("audio", "video")},
                    "selected_patterns": patterns}}

    audio = {"__module_spec__": "kinetics_sounds_audio_encoder",
             **{f"conv_block_{n}": block(i, o)
                for n, (i, o) in zip(("one", "two", "three"), KS_CONVS)},
             "dropout_one": rate(0.554), "dropout_two": rate(0.336),
             "fc_one_input_size": 512, "fc_one_output_size": 64, "fc_two_output_size": 64}
    video = {"__module_spec__": "kinetics_sounds_video_encoder", "fc_one_input_size": 400,
             "hidden_dim_one": 256, "hidden_dim_two": 128, "dropout": rate(0.56)}
    return {
        "experiment": {"name": KS_NAME, "seed": SEED, "device": "tpu", "is_train": True,
                       "is_test": True},
        "model": {"name": "KineticsSounds", "model_type": "kineticssounds",
                  "audio_encoder": audio, "video_encoder": video, "hidden_dim_one": 128,
                  "hidden_dim_two": 64, "dropout": rate(0.38)},
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 2,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy",
                                                          "loss_args": {}, "weight": 1.0}}},
        "data": {"datasets": {"train": split("train", ["av"], shuffle=True),
                              "validation": split("validation", KS_PATTERNS),
                              "test": split("test", KS_PATTERNS)}},
        "metrics": {"metrics": {
            "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
            "f1_weighted": {"function": "sklearn.metrics.f1_score",
                            "kwargs": {"average": "weighted", "zero_division": 0}}},
            "groups": {"classification": ["accuracy", "f1_weighted"]}},
        "logging": {"log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
                    "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
                    "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
                    "save_metric": "loss"},
        "monitoring": {"enabled": False},
    }


def phase_ks_check(dev, cfg_path: Path) -> dict:
    """Steps 1-3 and the epoch's padded tail (KS_TAIL_ROWS real rows of 64)
    from the same initial weights (every dropout 0, TF32 off) on the card and
    on the CPU in float32, the tail from the CPU's weights after step 3; the
    step-1 gradients in float64 on both devices."""
    import torch

    from mmtpu_torch.cli import common

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    batches = list(cfg.data.build_loader("train", seed=SEED))
    tail = batches[-1]
    if int(tail["sample_mask"].sum()) != KS_TAIL_ROWS:
        raise AssertionError(f"[ks check] tail has {tail['sample_mask'].sum()} real rows")
    cpu = torch.device("cpu")
    losses, models = {}, {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        model, _, step = _training_setup(cfg, device)
        losses[label] = [float(step(b)["loss"]) for b in batches[:3]]
        models[label] = (model, step)
    weights = models["cpu"][0].state_dict()
    models["gpu"][0].load_state_dict(weights)
    tail_loss = {label: float(step(tail)["loss"]) for label, (_, step) in models.items()}
    grads64 = {}
    for label, device in (("gpu", dev), ("cpu", cpu)):
        model, _, step = _training_setup(cfg, device)
        model.double()
        with _float64_losses():
            step(_as_float64(batches[0]))
        grads64[label] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    tail_rel = abs(tail_loss["gpu"] - tail_loss["cpu"]) / abs(tail_loss["cpu"])
    # a conv bias that feeds a BatchNorm has an exact gradient of 0 (phase
    # 9's rule): what both devices give there is rounding, held at 1e-12
    zero = {n for n, w in grads64["cpu"].items() if w.double().norm().item() < 1e-9}
    err64 = _grad_errors({n: g for n, g in grads64["gpu"].items() if n not in zero},
                         {n: g for n, g in grads64["cpu"].items() if n not in zero})
    zero_err = max([(grads64["gpu"][n] - grads64["cpu"][n]).abs().max().item()
                    for n in zero], default=0.0)
    worst = max(err64.values())
    say(f"[ks check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative {rel} (tolerances {TRAIN_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); padded tail "
        f"({KS_TAIL_ROWS} real rows of {KS_BATCH}) GPU {tail_loss['gpu']}, CPU "
        f"{tail_loss['cpu']} (relative {tail_rel:.3e}); step-1 float64 gradients, "
        f"{len(err64)} parameters: worst {worst:.3e} of its norm (tolerance "
        f"{TRAIN_GRAD64_TOL}), {_worst(err64)}; {len(zero)} with an exact gradient of 0: "
        f"largest |GPU - CPU| {zero_err:.3e} (tolerance 1e-12); TF32 off")
    if rel[0] > TRAIN_LOSS_RTOL or tail_rel > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[ks check] GPU and CPU losses differ: {rel}, tail {tail_rel}")
    if worst > TRAIN_GRAD64_TOL or zero_err > 1e-12:
        raise AssertionError(f"[ks check] float64 gradients differ by {worst} of their norm, "
                             f"{zero_err} where the exact gradient is 0")
    return {"loss_rel": rel, "tail_rel": tail_rel, "grad64_err": worst}


def ks_requests(csvs: dict) -> dict:
    """KS_REQUESTS test clips: a third with the video zeroed, a third with
    the audio."""
    from mmtpu_torch.data import KineticsSounds
    from mmtpu_torch.modalities import Modality

    ds = KineticsSounds(csvs["test"], "test", labels_key="class")
    audio = ds.arrays[Modality.AUDIO][:KS_REQUESTS].copy()
    video = ds.arrays[Modality.VIDEO][:KS_REQUESTS].copy()
    video[0::3] = 0.0
    audio[1::3] = 0.0
    return {"audio": audio, "video": video}


def phase_ks_predict(dev, card: str, work: Path, cfg_path: Path, csvs: dict) -> dict:
    """`predict --export` on the run's best checkpoint: 156 × 3 visits,
    none of the kernels; the logits against the CPU's (1e-3); the artifact
    on the card within EXPORT_TOL of the Predictor; the server on the run."""
    import torch

    from mmtpu_torch.cli import common, predict
    from mmtpu_torch.serving import Predictor, load_artifact
    from mmtpu_torch.train.step import make_eval_step

    art = work / "KineticsSounds.mmx"
    args = predict.arg_parser().parse_args(
        ["--config", str(cfg_path), "--run_id", "1", "--out",
         str(work / "predictions_ks.json"), "--export", str(art)])
    reset_counts()
    t0 = time.perf_counter()
    _, records, summary = predict.run(args)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    visits = KS_SAMPLES["test"] * len(KS_PATTERNS)
    if len(records) != visits or set(summary) != set(KS_PATTERNS) or any(counts.values()):
        raise AssertionError(f"[ks predict] {len(records)} records, {summary}, launches "
                             f"{counts}")
    cfg = common.load_config(args)
    tasks = {label: predict.build_task_and_loader(cfg, args, device)
             for label, device in (("gpu", dev), ("cpu", torch.device("cpu")))}
    batches = list(tasks["gpu"][1])
    gpu_step = make_eval_step(tasks["gpu"][0], dev)
    cpu_step = make_eval_step(tasks["cpu"][0], torch.device("cpu"))
    cpu_err = 0.0
    for i in (0, len(batches) - 1):
        g, c = gpu_step(batches[i]), cpu_step(batches[i])
        if g["logits"].shape != (KS_BATCH, 26) or not torch.isfinite(g["logits"]).all():
            raise AssertionError(f"[ks predict] logits {tuple(g['logits'].shape)}")
        cpu_err = max(cpu_err, (g["logits"].cpu() - c["logits"]).abs().max().item())
    served = load_artifact(art, dev)
    masked = _masked_batches(tasks["gpu"][1], KS_PATH["keys"])
    predictor = Predictor(tasks["gpu"][0], dev)
    reset_counts()
    art_out, art_s = _serving_pass(served, masked)
    art_counts = read_counts()
    pred_out, pred_s = _serving_pass(predictor, masked)
    art_err = _max_diff(art_out, pred_out)
    say_card(card, f"[ks predict] {len(records)} visits ({len(KS_PATTERNS)} patterns × "
             f"{KS_SAMPLES['test']}) in {seconds:.3f} s through predict.run with --export "
             f"({len(records) / seconds:.1f} visits/s, start-up and the export included); "
             f"per-pattern accuracy {summary}; launches {counts}; GPU vs CPU logits "
             f"{cpu_err:.3e} (tolerance {CPU_TOL}); artifact {art_s:.3f} s vs Predictor "
             f"{pred_s:.3f} s, launches inside it {art_counts}, max |artifact - Predictor| "
             f"{art_err:.3e} (tolerance {EXPORT_TOL})")
    if cpu_err > CPU_TOL or art_err > EXPORT_TOL or any(art_counts.values()):
        raise AssertionError(f"[ks predict] CPU {cpu_err}, artifact {art_err}, {art_counts}")
    srv = phase_serve(cfg_path, KS_PATH, ks_requests(csvs))
    return {"visits_per_s": len(records) / seconds, "cpu_err": cpu_err, "art_err": art_err,
            "serve": srv, "artifact_visits_per_s": len(records) / art_s,
            "predictor_visits_per_s": len(records) / pred_s}


def phase_ks(dev, card: str, work: Path) -> dict:
    """Phase 12 (b): Kinetics-Sounds through `train_multimodal.main` on the
    repository's clips: no launch of either kernel, as in mmtpu; a profiled
    window; the GPU-vs-CPU check; predict, export and serve."""
    from mmtpu_torch.cli import common, train_multimodal

    out_root = work / "ks"
    t0 = time.perf_counter()
    csvs = write_ks_csvs(work / "ks_data")
    cfg_path, check_path = work / "ks.json", work / "ks_check.json"
    cfg_path.write_text(json.dumps(ks_config(str(out_root), csvs)))
    check_path.write_text(json.dumps(ks_config(str(out_root), csvs, dropout=False)))
    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    loaders = {s: cfg.data.build_loader(s, seed=SEED) for s in KS_SAMPLES}
    read_s = time.perf_counter() - t0
    n = {s: len(loader) for s, loader in loaders.items()}
    want = {"train": -(-KS_SAMPLES["train"] // KS_BATCH),
            **{s: -(-KS_SAMPLES[s] * len(KS_PATTERNS) // KS_BATCH)
               for s in ("validation", "test")}}
    if n != want:
        raise AssertionError(f"[ks] batches {n}, expected {want}")
    reset_counts()
    run = _run_cli(train_multimodal, cfg_path, "[ks]", out_root, KS_NAME,
                   train_samples=KS_SAMPLES["train"])
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"[ks] launches {counts}, expected none")
    say_card(card, f"[ks] {sum(KS_SAMPLES.values())} clips read from "
             f"{2 * sum(KS_SAMPLES.values())} .pt files in {read_s:.2f} s; "
             f"{run['seconds']:.2f} s through train_multimodal.main (start-up, the reader and "
             f"checkpoints included); epoch {TRAIN_EPOCHS} train {run['epoch_s']:.3f} s = "
             f"{run['samples_per_s']:.1f} samples/s (B={KS_BATCH}); batches {n}; launches "
             f"{counts}; peak device memory {run['peak_bytes'] / 2**20:.1f} MiB")
    say(f"[ks] losses {run['losses']}; test {_accuracies(run['test'])}")
    profile = phase_train_profile(dev, card, cfg_path, tag="[ks profile]", batch=KS_BATCH)
    check = phase_ks_check(dev, check_path)
    pred = phase_ks_predict(dev, card, work, cfg_path, csvs)
    return {"run": run, "launches": counts, "profile": profile, "check": check,
            "predict": pred}


def mono_configs(out_root: str) -> dict:
    """The monomodal pretrainings ("text": TextCNN 768 → 64 with 128
    channels; "audio": LSTMEncoder 5 → 64 on the `lstm` kernel at G = 1;
    "mmimdb": MMIMDbModalityEncoder 300 → 512), each on its modality alone,
    2 epochs, and the fine-tunes that load their handoffs ("utt":
    UttFusion at the published widths from the text and audio encoders;
    "gmu": the GMU from the MM-IMDb text encoder), 1 epoch. MOSI at
    CMU-MOSI's split sizes, MM-IMDb at its own; the files' optimizers,
    losses and metrics."""
    import copy

    utt = utt_train_config(out_root)
    gmu = mmimdb_config(out_root)
    out = {}
    for key, mod, base, encoder in (
            ("text", "text", utt, utt["model"]["netT"]),
            ("audio", "audio", utt, utt["model"]["netA"]),
            ("mmimdb", "text", gmu, gmu["model"]["text_encoder"])):
        cfg = copy.deepcopy(base)
        cfg["experiment"]["name"] = MONO_NAMES[key]
        cfg["model"] = {"name": MONO_NAMES[key], "model_type": base["model"]["model_type"],
                        f"{mod}_encoder": copy.deepcopy(encoder)}
        cfg["training"]["num_modalities"] = 1
        for split in cfg["data"]["datasets"].values():
            split["missing_patterns"]["selected_patterns"] = [mod[0]]
        out[key] = cfg

    def handoff(key, mod):
        return f"{out_root}/{MONO_NAMES[key]}/models/{{run_id}}/encoder_{mod}_best.pth"

    for key, base, encoders in (("utt", utt, {"text": "text", "audio": "audio"}),
                                ("gmu", gmu, {"text": "mmimdb"})):
        cfg = copy.deepcopy(base)
        cfg["experiment"]["name"] = FINETUNE_NAMES[key]
        cfg["training"]["epochs"] = 1
        cfg["model"]["pretrained_encoders"] = {mod: handoff(src, mod)
                                               for mod, src in encoders.items()}
        out[key] = cfg
    return out


def _resident_steps(split: str, loader) -> int:
    """Steps of a split on the device-resident path: the train split's
    batches; an eval split's samples × patterns rows in fused batches (the
    loop's own `_auto_eval_factor`)."""
    from mmtpu_torch.train.loop import _auto_eval_factor

    if split == "train":
        return len(loader)
    rows = loader.dataset.num_samples * len(loader.pattern_vocab)
    return -(-rows // (loader.batch_size * _auto_eval_factor(loader.batch_size, rows)))


def _mono_batches(cfg_path: Path) -> dict:
    from mmtpu_torch.cli import common

    cfg = common.load_config(argparse.Namespace(config=str(cfg_path), run_id=1, seed=None))
    return {s: _resident_steps(s, cfg.data.build_loader(s, seed=SEED))
            for s in cfg.data.datasets}


def phase_mono(dev, card: str, work: Path) -> dict:
    """Phase 12 (c): `train_monomodal` on the card for the three encoders
    without `hidden_dim` (the LSTMEncoder's `lstm` exactly once per train
    batch and fused eval step), each writing encoder_{mod}_best.pth; then
    the UttFusion and GMU fine-tunes through `train_multimodal.main`, each
    loaded encoder's state sha256 equal to its file's."""
    import torch

    from mmtpu_torch.cli import common, train_monomodal, train_multimodal

    out_root = work / "mono"
    paths = {}
    for key, cfg in mono_configs(str(out_root)).items():
        paths[key] = work / f"mono_{key}.json"
        paths[key].write_text(json.dumps(cfg))
    runs, launches = {}, {}
    for key in ("text", "audio", "mmimdb"):
        n = _mono_batches(paths[key])
        reset_counts()
        runs[key] = _run_cli(train_monomodal, paths[key], f"[mono {key}]", out_root,
                             MONO_NAMES[key], train_samples=(
                                 MMIMDB_SAMPLES if key == "mmimdb" else UTT_SAMPLES)["train"])
        launches[key] = read_counts()
        want = {"fused_mlp": 0, "lstm": 0}
        if key == "audio":
            want["lstm"] = TRAIN_EPOCHS * (n["train"] + n["validation"]) + n["test"]
        if launches[key] != want:
            raise AssertionError(f"[mono {key}] launches {launches[key]}, expected {want} "
                                 f"({n} batches)")
        mod = "audio" if key == "audio" else "text"
        if not (runs[key]["models"] / f"encoder_{mod}_best.pth").exists():
            raise AssertionError(f"[mono {key}] no encoder_{mod}_best.pth")
        say_card(card, f"[mono {key}] {runs[key]['seconds']:.2f} s through "
                 f"train_monomodal.main; epoch {TRAIN_EPOCHS} train {runs[key]['epoch_s']:.3f} "
                 f"s = {runs[key]['samples_per_s']:.1f} samples/s; batches {n}; launches "
                 f"{launches[key]} (expected {want}); losses {runs[key]['losses']}")

    loaded = {}
    real_load = common.load_pretrained_encoders

    def spy(model, pretrained, logging_cfg):  # each encoder as the fine-tune loaded it
        out = real_load(model, pretrained, logging_cfg)
        for attr in ("netT", "netA", "text_encoder"):
            if hasattr(model, attr):
                loaded[attr] = _state_hash(getattr(model, attr).state_dict())
        return out

    fine = {}
    common.load_pretrained_encoders = spy
    try:
        for key in ("utt", "gmu"):
            samples = (UTT_SAMPLES if key == "utt" else MMIMDB_SAMPLES)["train"]
            t0 = time.perf_counter()
            rc = train_multimodal.main(["--config", str(paths[key]), "--run_id", "1"])
            fine[key] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"[mono {key}] fine-tune exit code {rc}")
            say_card(card, f"[mono {key}] fine-tune from the handoffs: {fine[key]:.2f} s "
                     f"through train_multimodal.main (1 epoch, {samples} train samples)")
    finally:
        common.load_pretrained_encoders = real_load
    files = {"netT": runs["text"]["models"] / "encoder_text_best.pth",
             "netA": runs["audio"]["models"] / "encoder_audio_best.pth",
             "text_encoder": runs["mmimdb"]["models"] / "encoder_text_best.pth"}
    for attr, path in files.items():
        in_file = _state_hash(torch.load(path, map_location="cpu", weights_only=True))
        if loaded.get(attr) != in_file:
            raise AssertionError(f"[mono] the fine-tune's {attr} ({loaded.get(attr)}) is not "
                                 f"{path.name}'s ({in_file})")
    say(f"[mono] the fine-tunes' encoders equal their handoffs: "
        + ", ".join(f"{attr} sha256 {loaded[attr][:16]}" for attr in files))
    return {"runs": runs, "launches": launches, "finetune_s": fine}


def say_phase12(card: str, export: Optional[dict], ks: Optional[dict], mono: Optional[dict],
                seconds: float) -> None:
    parts = []
    if export:
        for key in ("avmnist", "utt"):
            e = export[key]
            parts.append(f"{key} artifact {e['visits_per_s']:.1f} visits/s vs Predictor "
                         f"{e['predictor_visits_per_s']:.1f}, launches {e['launches']}")
        parts.append(f"serve --artifact {export['serve']['requests_per_s']:.1f} requests/s; "
                     f"DualCMAM artifact lstm {export['dual']['launches']} over "
                     f"{export['dual']['batches']} batches")
    if ks:
        parts.append(f"Kinetics-Sounds {ks['run']['samples_per_s']:.1f} train samples/s "
                     f"(epoch {TRAIN_EPOCHS}), {ks['profile']['kernels_per_step']:.1f} device "
                     f"kernels per step, busy share {ks['profile']['busy_share']:.3f}, "
                     f"launches {ks['launches']}")
    if mono:
        parts.append("monomodal " + ", ".join(
            f"{k} {r['samples_per_s']:.1f} samples/s" for k, r in mono["runs"].items())
            + f", audio lstm {mono['launches']['audio']['lstm']}")
    say_card(card, "[summary] phase 12: " + "; ".join(parts) + f"; phase {seconds:.1f} s")


# Phase 13: IEMOCAP's 10-fold CV at MMIN's UttFusion widths, the MM-IMDb
# chain (text pretraining → the pretrained_text_only fine-tune → C-MAM image
# → text with its artifact), and the recurrent registry encoders GPU vs CPU.
# The card's machine has no h5py (PERF.md §4): the IEMOCAP phase
# feeds the reader's assembling step with seeded features for the repo's
# fold files, and MM-IMDb runs on `synthetic_mmimdb`.
IEMOCAP_NAME = "IEMOCAP_UttFusion_CV"
IEMOCAP_ROOT = ROOT / "DATA" / "iemocap"
IEMOCAP_FOLDS = 10
IEMOCAP_SAMPLES = {"train": 1024, "validation": 256, "test": 256}  # per fold, DATA/iemocap/target
IEMOCAP_BATCH = 128
IEMOCAP_DIMS = {"audio": 130, "video": 342, "text": 1024}  # comparE, denseface, bert_large
IEMOCAP_FRAMES = (20, 64)  # frames per utterance, drawn as scripts/make_synthetic_iemocap.py does
IEMOCAP_MAX_LEN = 64
IEMOCAP_SNR = {"audio": 0.8, "video": 0.45, "text": 1.3}  # the generator's class signal
IEMOCAP_SPLITS = {"train": "trn", "validation": "val", "test": "tst"}
IEMOCAP_PATTERNS = ["atv", "at", "av", "tv", "a", "t", "v"]
CHAIN_NAMES = {"finetune": "mm_imdb_Pretrained_TextOnly_Training",
               "cmam": "MM_IMDb_C_MAM_Image_To_Text"}
CHAIN_BATCH = 128
RECURRENT_B, RECURRENT_T = 128, 64
TWIN_FWD_TOL = 1e-5  # a module's forward, GPU (TF32 off) vs CPU, of the output's scale
TWIN_GRAD_TOL = 1e-4  # of each parameter's gradient norm


def iemocap_pool(seed: int = SEED) -> dict:
    """Seeded features for every utterance the repo's fold files name: per
    modality a (T, dim) float32 matrix, T drawn from IEMOCAP_FRAMES for each
    modality on its own, standard normal noise plus the generator's class
    signal (a per-class direction scaled by IEMOCAP_SNR)."""
    from mmtpu_torch.data.iemocap import read_targets
    from mmtpu_torch.modalities import Modality

    labels = {}
    for ref in IEMOCAP_SPLITS.values():
        y, names = read_targets(IEMOCAP_ROOT / "target" / "1", ref)
        labels.update(zip(names, y.tolist()))
    g = np.random.default_rng(seed)
    mods = {m: Modality(m) for m in IEMOCAP_DIMS}
    protos = {m: g.standard_normal((4, d), dtype=np.float32) / np.sqrt(d)
              for m, d in IEMOCAP_DIMS.items()}
    lo, hi = IEMOCAP_FRAMES
    pool = {}
    for name in sorted(labels):
        pool[name] = {}
        for m, d in IEMOCAP_DIMS.items():
            x = g.standard_normal((int(g.integers(lo, hi + 1)), d), dtype=np.float32)
            pool[name][mods[m]] = x + IEMOCAP_SNR[m] * protos[m][labels[name]]
    return pool


@contextlib.contextmanager
def iemocap_features(pool: dict, shapes: list):
    """The IEMOCAP reader with its HDF5 step replaced by `pool` (the fold's
    comparE statistics zeros and ones, as the generator writes them); each
    assembled split's padded lengths appended to `shapes` as (cv, split,
    {modality: T})."""
    from mmtpu_torch.data import iemocap as reader

    real = {n: getattr(reader, n) for n in ("read_targets", "read_split", "assemble")}
    current = {}

    def read_targets(cv_root, ref_split):
        current.update(cv=int(Path(cv_root).name), split=ref_split)
        return real["read_targets"](cv_root, ref_split)

    def read_split(root, names, cv_no, feature_types):
        dim = IEMOCAP_DIMS["audio"]
        return ({mod: [pool[n][mod] for n in names] for mod in feature_types},
                np.zeros(dim, np.float32), np.ones(dim, np.float32))

    def assemble(*a, **k):
        arrays, lengths = real["assemble"](*a, **k)
        shapes.append((current["cv"], current["split"],
                       {str(m): arr.shape[1] for m, arr in arrays.items()}))
        return arrays, lengths

    for n, fn in (("read_targets", read_targets), ("read_split", read_split),
                  ("assemble", assemble)):
        setattr(reader, n, fn)
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(reader, n, fn)


def iemocap_expected(pool: dict) -> dict:
    """Per fold and split the padded lengths the reader will give (each
    modality's longest utterance in the split, at most IEMOCAP_MAX_LEN), and
    the `lstm` launches they imply: one per forward where audio and video
    share T (netA and netV stacked at G = 2), else two (G = 1 each); a
    forward per train batch and per fused eval step."""
    from mmtpu_torch.data.iemocap import read_targets
    from mmtpu_torch.modalities import Modality

    shapes, total = {}, 0
    batches = {"train": -(-IEMOCAP_SAMPLES["train"] // IEMOCAP_BATCH),
               **_eval_batches(IEMOCAP_SAMPLES, IEMOCAP_BATCH, len(IEMOCAP_PATTERNS))}
    for cv in range(1, IEMOCAP_FOLDS + 1):
        per = {}
        for split, ref in IEMOCAP_SPLITS.items():
            _, names = read_targets(IEMOCAP_ROOT / "target" / str(cv), ref)
            T = {m: min(max(pool[n][Modality(m)].shape[0] for n in names), IEMOCAP_MAX_LEN)
                 for m in IEMOCAP_DIMS}
            shapes[(cv, ref)] = T
            per[split] = 1 if T["audio"] == T["video"] else 2
        total += (TRAIN_EPOCHS * (batches["train"] * per["train"]
                                  + batches["validation"] * per["validation"])
                  + batches["test"] * per["test"])
    return {"shapes": shapes, "batches": batches, "total": total}


def iemocap_config(out_root: str, dropout: bool = True) -> dict:
    """IEMOCAP UttFusion at the widths of MMIN's IEMOCAP baseline (comparE
    130 → LSTM 128 and denseface 342 → LSTM 128, both maxpool; bert_large
    1024 → TextCNN 128; FcClassifier 384 → [128, 128] → 4, dropout 0.3),
    batch 128, Adam 1e-3, 2 epochs per fold, train `atv`, evaluation over the
    seven patterns, IEMOCAP_FOLDS-fold CV on the repo's fold files. `dropout=False`
    sets TextCNN's and the classifier's dropout to 0 (the GPU-vs-CPU check)."""
    def split(name, patterns, **extra):
        return {"dataset": "iemocap", "data_fp": str(IEMOCAP_ROOT), "split": name,
                "target_modality": "MULTIMODAL", "batch_size": IEMOCAP_BATCH, **extra,
                "kwargs": {"norm_method": "trn", "max_len": IEMOCAP_MAX_LEN},
                "missing_patterns": {
                    "modalities": {m: {"missing_rate": 0.0} for m in IEMOCAP_DIMS},
                    "selected_patterns": patterns}}

    return {
        "experiment": {"name": IEMOCAP_NAME, "seed": SEED, "device": "tpu", "is_train": True,
                       "is_test": True, "cross_validation": IEMOCAP_FOLDS},
        "model": {
            "name": "UttFusion", "model_type": "utt-fusion",
            "netA": {"__module_spec__": "lstmencoder", "input_size": IEMOCAP_DIMS["audio"],
                     "hidden_size": 128, "embd_method": "maxpool"},
            "netV": {"__module_spec__": "lstmencoder", "input_size": IEMOCAP_DIMS["video"],
                     "hidden_size": 128, "embd_method": "maxpool"},
            "netT": {"__module_spec__": "textcnn", "input_size": IEMOCAP_DIMS["text"],
                     "embd_size": 128, "out_channels": 128, "dropout": 0.5 if dropout else 0.0},
            "netC": {"__module_spec__": "fcclassifier", "input_dim": 384, "layers": [128, 128],
                     "output_dim": 4, "dropout": 0.3 if dropout else 0.0},
        },
        "training": {"epochs": TRAIN_EPOCHS, "early_stopping": False, "num_modalities": 3,
                     "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001}},
                     "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy",
                                                          "loss_args": {}, "weight": 1.0}}},
        "data": {"datasets": {"train": split("train", ["atv"], shuffle=True),
                              "validation": split("valid", IEMOCAP_PATTERNS),
                              "test": split("test", IEMOCAP_PATTERNS)}},
        "metrics": {"metrics": {
            "F1_Macro": {"function": "sklearn.metrics.f1_score",
                         "kwargs": {"average": "macro", "zero_division": 0}},
            "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}}},
            "groups": {"classification": ["F1_Macro", "accuracy"]}},
        "logging": {
            "log_path": f"{out_root}/{{experiment_name}}/logs/{{run_id}}",
            "model_output_path": f"{out_root}/{{experiment_name}}/models/{{run_id}}",
            "metrics_path": f"{out_root}/{{experiment_name}}/metrics/{{run_id}}",
            "save_metric": "F1_Macro_ATV"},
        "monitoring": {"enabled": False},
    }


def phase_iemocap_check(dev, cfg_path: Path) -> dict:
    """Fold 1's first three train steps from the same initial weights
    (dropout 0, TF32 off) on the card and on the CPU: losses (step 1 at
    UTT_LOSS_RTOL, steps 2-3 at TRAIN_LATER_RTOL) and the step-1 gradient of
    every parameter within UTT_GRAD_TOL of its norm."""
    import torch

    cfg, batches = _train_batches(cfg_path, 3)
    losses, grads = {}, {}
    for label, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        model, _, step = _training_setup(cfg, device)
        losses[label] = []
        for b in batches:
            losses[label].append(float(step(b)["loss"]))
            grads.setdefault(label, {n: p.grad.detach().cpu().clone()
                                     for n, p in model.named_parameters()})
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    err = _grad_errors(grads["gpu"], grads["cpu"])
    say(f"[iemocap check] float32 losses of steps 1-3, GPU {losses['gpu']}, CPU "
        f"{losses['cpu']}: relative {rel} (tolerances {UTT_LOSS_RTOL}, then "
        f"{TRAIN_LATER_RTOL}); step-1 gradients, {len(err)} parameters: worst "
        f"{max(err.values()):.3e} of its norm (tolerance {UTT_GRAD_TOL}), whole "
        f"{_whole_error(grads['gpu'], grads['cpu']):.3e}, worst {_worst(err)}; TF32 off")
    if rel[0] > UTT_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[iemocap check] GPU and CPU losses differ: {rel}")
    if max(err.values()) > UTT_GRAD_TOL:
        raise AssertionError(f"[iemocap check] step-1 gradients differ: {_worst(err)}")
    return {"loss_rel": rel, "grad_err": max(err.values())}


def phase_iemocap(dev, card: str, work: Path, pool: dict) -> dict:
    """Phase 13 (a): IEMOCAP's 10-fold CV through `train_multimodal.main` on
    the card; `lstm` launches equal to the count derived beforehand from the
    reader's padded lengths (and those lengths equal to what the reader gave);
    the three `*_metrics_agg.json`; a profiled window of 8 fold-1 train steps;
    GPU vs CPU steps."""
    import torch

    from mmtpu_torch.cli import train_multimodal

    out_root = work / "iemocap"
    cfg_path = work / "iemocap.json"
    cfg_path.write_text(json.dumps(iemocap_config(str(out_root))))
    expected = iemocap_expected(pool)
    shapes = []
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    t0 = time.perf_counter()
    with iemocap_features(pool, shapes):
        rc = train_multimodal.main(["--config", str(cfg_path), "--run_id", "1"])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"[iemocap] exit code {rc}")
    got = {(cv, ref): T for cv, ref, T in shapes}
    if len(shapes) != 3 * IEMOCAP_FOLDS or got != expected["shapes"]:
        raise AssertionError(f"[iemocap] the reader's padded lengths {shapes} are not the "
                             f"derived {expected['shapes']}")
    if counts != {"fused_mlp": 0, "lstm": expected["total"]}:
        raise AssertionError(f"[iemocap] launches {counts}, derived lstm {expected['total']} "
                             f"(batches per fold {expected['batches']}) and no fused_mlp")
    metrics = out_root / IEMOCAP_NAME / "metrics" / "1"
    rates = []
    for fold in range(1, IEMOCAP_FOLDS + 1):
        epochs = [e for e in json.loads((metrics / f"fold_{fold}/epoch_metrics.json")
                                        .read_text()) if "epoch" in e]
        if len(epochs) != TRAIN_EPOCHS or not np.isfinite(epochs[-1]["train"]["loss"]):
            raise AssertionError(f"[iemocap] fold {fold}: {len(epochs)} epochs")
        rates.append(IEMOCAP_SAMPLES["train"] / epochs[-1]["train"]["timing"]["total_time"])
    agg = {s: json.loads((metrics / f"{s}_metrics_agg.json").read_text())
           for s in ("train", "validation", "test")}
    keys = {s: sorted(a[0]) for s, a in agg.items()}
    want_test = {"loss"} | {f"{m}_{p.upper()}" for m in ("F1_Macro", "accuracy")
                            for p in IEMOCAP_PATTERNS}
    if set(keys["test"]) != want_test or len(agg["validation"]) != TRAIN_EPOCHS or not all(
            np.isfinite(v) for v in agg["test"][0].values()):
        raise AssertionError(f"[iemocap] aggregates {keys}")
    T = sorted({tuple(sorted(t.items())) for t in got.values()})
    say_card(card, f"[iemocap] {IEMOCAP_FOLDS} folds through train_multimodal.main in "
             f"{seconds:.2f} s (the seeded features' assembly, start-up and checkpoints "
             f"included); epoch {TRAIN_EPOCHS} train samples/s per fold "
             f"{[round(r, 1) for r in rates]} (B={IEMOCAP_BATCH}, "
             f"{IEMOCAP_SAMPLES['train']} samples)")
    say(f"[iemocap] padded lengths the reader gave (distinct per split): {T}; lstm launches "
        f"{counts['lstm']} = the derived {expected['total']} (batches per fold "
        f"{expected['batches']}); fused_mlp {counts['fused_mlp']}; aggregate keys {keys}; "
        f"test ATV {({k: round(v, 4) for k, v in agg['test'][0].items() if k.endswith('ATV')})}")
    profile = phase_iemocap_profile(dev, card, cfg_path, pool)
    check_path = work / "iemocap_check.json"
    check_path.write_text(json.dumps(iemocap_config(str(out_root), dropout=False)))
    with iemocap_features(pool, []):
        check = phase_iemocap_check(dev, check_path)
    return {"seconds": seconds, "samples_per_s": rates, "launches": counts,
            "profile": profile, "check": check}


def phase_iemocap_profile(dev, card: str, cfg_path: Path, pool: dict, steps: int = 8) -> dict:
    """A window of fold-1 train steps under the profiler (the train split's 8
    batches after 3 warm-up steps): kernels and launch calls per step, the
    device's time and busy share, `lstm` per step as the reader's T gives."""
    import torch

    shapes = []
    with iemocap_features(pool, shapes):
        cfg, batches = _train_batches(cfg_path, 3 + steps)
    T = shapes[0][2]
    per_step = 1 if T["audio"] == T["video"] else 2
    _, _, step = _training_setup(cfg, dev)
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(lambda: [step(b) for b in batches[3:]], top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"[iemocap profile] {steps} train steps (B={IEMOCAP_BATCH}, T {T}): "
             f"{brk['kernel_events'] / steps:.1f} device kernels and "
             f"{brk['launch_calls'] / steps:.1f} launch calls per step; device "
             f"{brk['device_ms'] / steps:.3f} ms per step of {brk['profiled_wall_ms'] / steps:.3f}"
             f" ms wall, busy share {busy:.3f}; lstm launches {counts['lstm']} (device "
             f"{brk['own_ms']['lstm']:.4f} ms); top device operations (name, ms, count) "
             f"{brk['top']}; top host operations (name, ms, count) {brk['top_host']}")
    if counts["lstm"] != per_step * steps:
        raise AssertionError(f"[iemocap profile] lstm {counts['lstm']} in {steps} steps")
    return {"busy_share": busy, "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps,
            "device_ms_per_step": brk["device_ms"] / steps}


def chain_configs(out_root: str, handoff: Path) -> dict:
    """configs/mmimdb_pretrained_text_only.yaml's model and optimizers at its
    published widths (MMIMDbModalityEncoder 4096 / 300 → 512, GMU 512,
    classifier 512 → 512 → 23; Adam 1e-5 with the encoders' group at 1e-6,
    L2 1e-3; batch 128; its four F1s; an embeddings split) on
    `synthetic_mmimdb` at MM-IMDb's split sizes, 1 epoch, loading the text
    handoff; and C-MAM image → text over its best checkpoint (the image
    encoder copied, an AssociationNetwork 512 → 256 → 512 with BatchNorm,
    the `cmam` loss without its classification term, the four F1s and mae /
    mse / cosine: the reference's C-MAM record keys), 1 epoch."""
    import copy

    fine = mmimdb_config(out_root)
    fine["experiment"]["name"] = CHAIN_NAMES["finetune"]
    fine["model"]["pretrained_encoders"] = {"text": str(handoff)}
    def adam(lr):
        return {"name": "Adam", "default_kwargs": {"lr": lr, "weight_decay": 0.001}}

    fine["training"].update(epochs=1, optimizer=adam(0.00001), encoder_optimizer=adam(0.000001))
    datasets = fine["data"]["datasets"]
    for split in datasets.values():
        split["batch_size"] = CHAIN_BATCH
    datasets["embeddings"] = copy.deepcopy(datasets["test"])
    f1 = {f"f1_{avg}": {"function": "sklearn.metrics.f1_score",
                        "kwargs": {"average": avg, "zero_division": 0}}
          for avg in ("samples", "macro", "weighted", "micro")}
    fine["metrics"] = {"metrics": f1, "groups": {"classification": list(f1)}}

    cmam = {k: copy.deepcopy(fine[k]) for k in ("logging", "monitoring")}
    cmam["experiment"] = {**fine["experiment"], "name": CHAIN_NAMES["cmam"]}
    cmam["model"] = {k: v for k, v in copy.deepcopy(fine["model"]).items()
                     if k != "pretrained_encoders"}
    cmam["model"]["pretrained_path"] = (f"{out_root}/{CHAIN_NAMES['finetune']}/models/"
                                        "{run_id}/best.ckpt")
    cmam["cmam"] = {
        "name": "CMAM", "model_type": "CMAM", "target_modality": "text",
        "load_pretrained_encoder_state_for": ["image"],
        "input_encoders": {"__module_spec__": "input_encoders",
                           "image": copy.deepcopy(fine["model"]["image_encoder"])},
        "association_network": {"__module_spec__": "association_network", "input_size": 512,
                                "hidden_size": 256, "output_size": 512, "batch_norm": True,
                                "dropout": 0.0}}
    cmam["target_modality"] = "text"
    cmam["training"] = {
        "epochs": 1, "early_stopping": False, "num_modalities": 2,
        "optimizer": {"name": "Adam", "default_kwargs": {"lr": 0.001, "weight_decay": 0.0001}},
        "loss_functions": {"cmam": {"loss_name": "cmam", "weight": 1.0, "loss_kwargs": {
            "cosine_weight": 1.0, "mae_weight": 1.0, "mse_weight": 1.0, "cls_weight": 0.0}}}}
    cmam["data"] = {"datasets": copy.deepcopy(
        {k: v for k, v in datasets.items() if k != "embeddings"})}
    for split in cmam["data"]["datasets"].values():
        split["missing_patterns"]["selected_patterns"] = ["it"]
    cmam["metrics"] = {"metrics": {**f1, **{
        "mae": {"function": "sklearn.metrics.mean_absolute_error", "kwargs": {}},
        "mse": {"function": "sklearn.metrics.mean_squared_error", "kwargs": {}},
        "cosine": {"function": "metrics.cosine_similarity", "kwargs": {}}}},
        "groups": {"classification": list(f1), "reconstruction": ["mae", "mse", "cosine"]}}
    return {"finetune": fine, "cmam": cmam}


def phase_mmimdb_chain(dev, card: str, work: Path, handoff: Optional[Path] = None) -> dict:
    """Phase 13 (b): the MM-IMDb text pretraining (phase 12 (c)'s handoff
    where it ran), the pretrained_text_only fine-tune, C-MAM image → text
    with `--export-serving`, all through their `main`s on the card: the
    loaded text encoder's sha256 equal to its file's, the teacher's equal to
    its file's before and after C-MAM, no launch of either kernel, the C-MAM
    record keys equal tests/golden/reference_cmam's, the artifact within
    EXPORT_TOL of the eager C-MAM serving function on the card."""
    import torch

    from mmtpu_torch.cli import common, train_cmam, train_monomodal, train_multimodal
    from mmtpu_torch.serving import load_artifact, make_cmam_serving_fn
    from mmtpu_torch.train import cmam_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_root = work / "chain"
    reset_counts()
    if handoff is None:
        mono_path = work / "chain_mono.json"
        mono_path.write_text(json.dumps(mono_configs(str(out_root))["mmimdb"]))
        mono = _run_cli(train_monomodal, mono_path, "[chain mono]", out_root,
                        MONO_NAMES["mmimdb"], train_samples=MMIMDB_SAMPLES["train"])
        handoff = mono["models"] / "encoder_text_best.pth"
        say_card(card, f"[chain] text pretraining: {mono['seconds']:.2f} s through "
                 f"train_monomodal.main, epoch {TRAIN_EPOCHS} {mono['samples_per_s']:.1f} "
                 "samples/s")
    paths = {}
    for key, cfg in chain_configs(str(out_root), handoff).items():
        paths[key] = work / f"chain_{key}.json"
        paths[key].write_text(json.dumps(cfg))

    loaded, real_load = {}, common.load_pretrained_encoders

    def spy(model, pretrained, logging_cfg):
        out = real_load(model, pretrained, logging_cfg)
        loaded["text"] = _state_hash(model.text_encoder.state_dict())
        return out

    common.load_pretrained_encoders = spy
    try:
        t0 = time.perf_counter()
        rc = train_multimodal.main(["--config", str(paths["finetune"]), "--run_id", "1"])
        fine_s = time.perf_counter() - t0
    finally:
        common.load_pretrained_encoders = real_load
    if rc != 0:
        raise AssertionError(f"[chain] fine-tune exit code {rc}")
    in_file = _state_hash(torch.load(handoff, map_location="cpu", weights_only=True))
    if loaded.get("text") != in_file:
        raise AssertionError(f"[chain] the fine-tune's text encoder {loaded.get('text')} is not "
                             f"its file's {in_file}")
    fine_metrics = out_root / CHAIN_NAMES["finetune"] / "metrics/1"
    fine_epoch = json.loads((fine_metrics / "epoch_metrics.json").read_text())[0]
    fine_rate = MMIMDB_SAMPLES["train"] / fine_epoch["train"]["timing"]["total_time"]
    best = out_root / CHAIN_NAMES["finetune"] / "models/1/best.pth"
    teacher_file = _state_hash(torch.load(best, map_location="cpu", weights_only=True)["model"])

    teachers, real_post = [], cmam_step.CMAMTask.__post_init__

    def post(task):
        real_post(task)
        teachers.append((task.base_model, _state_hash(task.base_model.state_dict())))

    art = work / "chain_cmam.mmx"
    cmam_step.CMAMTask.__post_init__ = post
    try:
        t0 = time.perf_counter()
        with _timed_export() as times:
            rc = train_cmam.main(["--config", str(paths["cmam"]), "--run_id", "1",
                                  "--export-serving", str(art)])
        cmam_s = time.perf_counter() - t0
    finally:
        cmam_step.CMAMTask.__post_init__ = real_post
    if rc != 0:
        raise AssertionError(f"[chain] train_cmam exit code {rc}")
    counts = read_counts()
    (teacher, before), = teachers
    after = _state_hash(teacher.state_dict())
    if not before == after == teacher_file:
        raise AssertionError(f"[chain] teacher sha256: file {teacher_file}, restored {before}, "
                             f"after the run {after}")
    if counts != {"fused_mlp": 0, "lstm": 0}:
        raise AssertionError(f"[chain] launches {counts}; the chain runs neither kernel")
    metrics = out_root / CHAIN_NAMES["cmam"] / "metrics/1"
    golden = ROOT / "tests/golden/reference_cmam"
    cmam_rate = None
    for split in ("train", "validation", "test"):
        ours = json.loads((metrics / f"{split}_metrics.json").read_text())
        gold = json.loads((golden / f"{split}_metrics.json").read_text())
        for group in ("classification", "reconstruction"):
            if set(ours[0][group]) != set(gold[0][group]):
                raise AssertionError(f"[chain] {split} {group} keys {sorted(ours[0][group])}, "
                                     f"the reference's {sorted(gold[0][group])}")
        if set(ours[0]) != set(gold[0]) or not np.isfinite(ours[0]["loss"]):
            raise AssertionError(f"[chain] {split} record keys {sorted(ours[0])}, the "
                                 f"reference's {sorted(gold[0])}")
    test_record = json.loads((metrics / "test_metrics.json").read_text())[0]
    cmam_epoch = json.loads((metrics / "epoch_metrics.json").read_text())[0]
    cmam_rate = MMIMDB_SAMPLES["train"] / cmam_epoch["train"]["timing"]["total_time"]

    served = load_artifact(art, dev)
    meta = served.meta
    if (meta["task_type"], meta["imputes"], meta["input_keys"]) != ("cmam", ["text"],
                                                                    ["image"]):
        raise AssertionError(f"[chain] artifact meta {meta}")
    ccfg = _cmam_config(paths["cmam"])
    built = train_cmam.assemble(ccfg, dev)
    state = torch.load(out_root / CHAIN_NAMES["cmam"] / "models/1/best.pth", map_location=dev,
                       weights_only=False)
    built.cmam.load_state_dict(state["model"])
    eager = make_cmam_serving_fn(built.task)

    def reference(**ins):
        with torch.inference_mode():
            out = eager(torch.from_numpy(ins["image"]).to(dev))
        return {k: v.cpu().numpy() for k, v in out.items()}

    batches = _masked_batches(ccfg.data.build_loader("test", seed=SEED), ["image"])
    for fn in (served, reference):
        fn(**batches[0])
    art_out, art_s = _serving_pass(served, batches)
    ref_out, ref_s = _serving_pass(reference, batches)
    err = _max_diff(art_out, ref_out)
    say_card(card, f"[chain] fine-tune of mmimdb_pretrained_text_only's model: {fine_s:.2f} s "
             f"through train_multimodal.main (1 epoch, {fine_rate:.1f} train samples/s, "
             f"B={CHAIN_BATCH}); text encoder sha256 {in_file[:16]} = its handoff's; C-MAM "
             f"image → text: {cmam_s:.2f} s through train_cmam.main (1 epoch, "
             f"{cmam_rate:.1f} train samples/s, export {times[-1]:.2f} s, "
             f"{art.stat().st_size / 2**20:.1f} MiB); teacher sha256 {after[:16]} = its "
             f"file's before and after; launches {counts}; artifact over "
             f"{MMIMDB_SAMPLES['test']} test visits {art_s:.3f} s vs eager {ref_s:.3f} s, max "
             f"|artifact - eager| {err:.3e} (tolerance {EXPORT_TOL})")
    say(f"[chain] C-MAM record keys = tests/golden/reference_cmam's; test record "
        f"{ {k: v for k, v in test_record.items() if k != 'index'} }")
    if err > EXPORT_TOL:
        raise AssertionError(f"[chain] the artifact differs from the eager forward by {err}")
    return {"finetune_samples_per_s": fine_rate, "cmam_samples_per_s": cmam_rate,
            "launches": counts, "err": err}


def recurrent_cases() -> dict:
    """name → (module factory, positional inputs' widths or None for the
    lengths, expected `lstm` launches per forward). Widths at IEMOCAP's
    feature sizes and the SeqEncoder's 128-wide output."""
    from mmtpu_torch.models import domain, variational

    a, v, t = (IEMOCAP_DIMS[m] for m in ("audio", "video", "text"))
    return {
        "VariationalLSTMEncoder(130, 128)": (
            lambda: variational.VariationalLSTMEncoder(a, 128), [a, "audio"], 1),
        "VariationalLSTMEncoder2(342, 128, attention)": (
            lambda: variational.VariationalLSTMEncoder2(v, 128, "attention"), [v, "video"], 1),
        "SeqEncoder(130, 1024, 342, 128, lstm)": (
            lambda: domain.SeqEncoder(a, t, v, 128, proj_type="lstm"),
            [t, v, a, "text"], 3),
        "DIVEncoder(128, 128, rnn lstm, avg, disc)": (
            lambda: domain.DIVEncoder(128, 128, prj_type="rnn", rnn_type="lstm",
                                      rdc_type="avg", use_disc=True),
            [128, 128, "text"], 2),
        "SeqEncoder(130, 1024, 342, 128, gru)": (
            lambda: domain.SeqEncoder(a, t, v, 128, proj_type="gru"), [t, v, a, "text"], 0),
        "DIVEncoder(128, 128, rnn gru, last)": (
            lambda: domain.DIVEncoder(128, 128, prj_type="rnn", rnn_type="gru",
                                      rdc_type="last"), [128, 128, "text"], 0),
    }


def phase_recurrent(dev, pool: dict) -> dict:
    """Phase 13 (c): each recurrent encoder's forward and one backward on the
    card against the port on the CPU from the same seeded weights (eval mode:
    ε = 0, no dropout; TF32 off), at B = 128, T = 64 with the IEMOCAP
    reader's lengths for fold 1's first 128 train utterances; the `lstm`
    launches of the forward exactly as derived, and a gradient for every
    parameter."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.data.iemocap import assemble, read_targets
    from mmtpu_torch.modalities import Modality

    _, names = read_targets(IEMOCAP_ROOT / "target" / "1", "trn")
    names = names[:RECURRENT_B]
    _, lengths = assemble({Modality(m): [pool[n][Modality(m)] for n in names]
                           for m in IEMOCAP_DIMS}, None, None, "trn", IEMOCAP_MAX_LEN)
    g = np.random.default_rng(SEED)
    results = {}
    for name, (factory, widths, launches) in recurrent_cases().items():
        args = [torch.from_numpy(g.standard_normal((RECURRENT_B, RECURRENT_T, w),
                                                   dtype=np.float32))
                if isinstance(w, int) else torch.from_numpy(lengths[Modality(w)].astype(np.int64))
                for w in widths]
        module = common.init_model(factory(), SEED, torch.device("cpu"))
        results[name] = _twin_check(dev, module, args, f"[recurrent] {name}", launches)
        if results[name]["unreached"]:
            raise AssertionError(f"[recurrent] {name}: parameters without a gradient")
    return results


def _output_leaves(out) -> list:
    """The tensors of a nested output (dicts in key order by name), None
    dropped."""
    if out is None:
        return []
    if isinstance(out, dict):
        return [x for k in sorted(out, key=str) for x in _output_leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _output_leaves(o)]
    return [out]


def say_phase13(card: str, iemocap: Optional[dict], chain: Optional[dict],
                recurrent: Optional[dict], seconds: float) -> None:
    parts = []
    if iemocap:
        parts.append(f"IEMOCAP {IEMOCAP_FOLDS} folds in {iemocap['seconds']:.1f} s, epoch-2 "
                     f"train samples/s {min(iemocap['samples_per_s']):.1f}–"
                     f"{max(iemocap['samples_per_s']):.1f}, lstm {iemocap['launches']['lstm']}, busy "
                     f"share {iemocap['profile']['busy_share']:.3f}")
    if chain:
        parts.append(f"MM-IMDb fine-tune {chain['finetune_samples_per_s']:.1f} and C-MAM "
                     f"{chain['cmam_samples_per_s']:.1f} train samples/s, artifact "
                     f"{chain['err']:.3e}")
    if recurrent:
        parts.append("recurrent encoders lstm " + ", ".join(
            f"{r['launches']}" for r in recurrent.values()))
    say_card(card, "[summary] phase 13: " + "; ".join(parts) + f"; phase {seconds:.1f} s")


PHASE14_LOSS_RTOL = 1e-5  # step 1 (and MulT's padded tail), GPU (TF32 off) vs CPU
PHASE14_GRAD_TOL = 1e-4  # of each parameter's gradient norm, step 1
CROSS_ENTROPY = {"cross_entropy": {"loss_name": "cross_entropy", "weight": 1.0}}
# MulT at the Multimodal-Transformer repository's CMU-MOSI defaults (Tsai et
# al., ACL 2019, main.py): 30-wide attention, 5 heads, 5 layers, the class's
# dropouts, batch 24, clip 0.8, Adam 1e-3; inputs at the repo's MOSI twin widths
MULT_DIMS = {"audio": 5, "video": 20, "text": 768}
MULT_T = 50
MULT_SAMPLES = 324  # a quarter of CMU-MOSI's train split of 1284: 13 batches of 24 and its tail of 12
MULT_BATCH = 24
MULT_MODEL = dict(attention_dim=30, num_heads=5, num_layers=5, output_dim=3)
MULT_CLIP = 0.8
MULT_LAMBDA_D = 0.1
MULT_NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0, embd_dropout=0.0,
                       residual_dropout=0.0, output_dropout=0.0)
# GCNet on IEMOCAP-sized conversations: the repo's IEMOCAP feature widths,
# DialogueRNN's 120 IEMOCAP training dialogues, lengths seeded in 20..110;
# D_e, the graph width, windows and batch are not published ones: GCNet's
# IEMOCAP script is not in the repository
GCNET_DIALOGUES = 72  # 4 batches of 16 and a tail of 8 real rows
GCNET_BATCH = 16
GCNET_T = 110
GCNET_LENGTHS = (20, 110)
GCNET_MODEL = dict(D_e=100, graph_hidden_size=100, n_speakers=2, window_past=2,
                   window_future=2, n_classes=6, dropout=0.5, time_attn=True)
GCNET_LSTM_PER_FORWARD = {"LSTM": 6, "GRU": 4}  # base 2 layers + 2 fusion layers × 2 nets
# GCNet's profiled window: ~57,000 kernels per step (the LSTM backward's eager
# recompute), whose ~3 million profiler events over 8 steps took ~4 minutes to
# post-process; 2 steps of the device activity alone
GCNET_PROFILE_STEPS = 2
# EFModelAL at the IEMOCAP widths: FcClassifier 130 → [128] → 128 and
# LSTMClassifier (1024, 128, fc1 128, 4), fusion 128, 4 classes
EF_B = 128
EF_T = 64
EF_PAD_ROWS = 28  # the padded tail of the BatchNorm check
EF_LSTM_PER_FORWARD = 2


def _tf32_off() -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _attention_grad_errors(grads: dict, ref: dict) -> dict:
    """`_grad_errors`, except that an attention's key bias, whose exact
    gradient is 0 (the softmax over the keys ignores a shift they share) and
    which holds only rounding on either device, is set against the whole
    gradient's norm."""
    whole = np.sqrt(sum(float(w.double().norm()) ** 2 for w in ref.values()))
    errs = _grad_errors(grads, ref)
    for n, w in ref.items():
        if n.endswith("key.bias"):
            errs[n] = (grads[n].double() - w.double()).abs().max().item() / whole
    return errs


def mult_batches(seed: int = SEED) -> list:
    """CMU-MOSI-sized train batches at MulT's widths from seeded normals:
    53 full batches of 24 and a zero-padded tail of 12 real rows."""
    g = np.random.default_rng(seed)
    data = {m: g.standard_normal((MULT_SAMPLES, MULT_T, d), dtype=np.float32)
            for m, d in MULT_DIMS.items()}
    labels = g.integers(0, MULT_MODEL["output_dim"], MULT_SAMPLES).astype(np.int32)
    batches = []
    for start in range(0, MULT_SAMPLES, MULT_BATCH):
        n = min(MULT_BATCH, MULT_SAMPLES - start)
        b = {m: np.zeros((MULT_BATCH, MULT_T, d), np.float32) for m, d in MULT_DIMS.items()}
        for m in MULT_DIMS:
            b[m][:n] = data[m][start:start + n]
        b["labels"] = np.zeros(MULT_BATCH, np.int32)
        b["labels"][:n] = labels[start:start + n]
        b["sample_mask"] = (np.arange(MULT_BATCH) < n).astype(np.float32)
        batches.append(b)
    return batches


def _adam_state(model, clip=None):
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.state import TrainState

    optimizer, _ = build_optimizer(OptimizerConfig(name="adam", default_kwargs={"lr": 1e-3}),
                                   model)
    return TrainState(model=model, optimizer=optimizer, clip=clip)


def mult_setup(device, discriminator: bool, dropout: bool = True):
    """MulT from the registry with seeded weights, and the port's generic
    train step over ClassificationTask with Adam and the 0.8 clip."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.models import build_module
    from mmtpu_torch.train.losses import LossFunctionGroup
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    kw = dict(orig_dim_a=MULT_DIMS["audio"], orig_dim_t=MULT_DIMS["text"],
              orig_dim_v=MULT_DIMS["video"], **MULT_MODEL, use_discriminator=discriminator,
              lambda_d=MULT_LAMBDA_D, **({} if dropout else MULT_NO_DROPOUT))
    model = common.init_model(build_module("mult", **kw), SEED, device)
    state = _adam_state(model, clip=MULT_CLIP)
    state.generator = common.use_run_generator(model, SEED, device)
    task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(CROSS_ENTROPY),
                              input_keys=tuple(MULT_DIMS))
    return model, make_train_step(task, state, device)


def _profile_steps(card: str, tag: str, fn, steps: int) -> dict:
    """`steps` train steps under the profiler: kernels and launch calls per
    step, the device's busy share, the `lstm` launches among them."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    brk = device_breakdown(fn, top=8)
    counts = read_counts()
    busy = brk["device_ms"] / brk["profiled_wall_ms"]
    say_card(card, f"{tag} {steps} train steps: {brk['kernel_events'] / steps:.1f} device "
             f"kernels and {brk['launch_calls'] / steps:.1f} host launch calls per step; "
             f"device busy {brk['device_ms']:.3f} ms of {brk['profiled_wall_ms']:.3f} ms wall, "
             f"busy share {busy:.3f}; launches {counts}; top device operations (name, ms, "
             f"count) {brk['top']}; top host operations by self CPU time (name, ms, count) "
             f"{brk['top_host']}")
    return {"busy_share": busy, "kernels_per_step": brk["kernel_events"] / steps,
            "launch_calls_per_step": brk["launch_calls"] / steps, "counts": counts}


def phase_mult_check(dev, discriminator: bool, batches: list) -> dict:
    """MulT's first three generic train steps from the same seeded weights
    (dropouts 0, TF32 off) on the card and on the CPU, then the padded tail
    (12 real rows of 24) from the CPU's weights after step 3 on both: the
    float32 losses. The step-1 gradients (after the 0.8 clip) of every
    parameter against its norm are judged in float64 on both devices (no
    kernel runs on this path, so both can): in float32 the card's gradients
    miss the exact ones by ~1e-3 of their norm, which would hide a fault.
    The float32 errors are printed, and the card's again with cuDNN off."""
    import torch

    t0 = time.perf_counter()
    _tf32_off()
    tail = batches[-1]
    if int(tail["sample_mask"].sum()) != MULT_SAMPLES % MULT_BATCH:
        raise AssertionError(f"MulT's tail holds {int(tail['sample_mask'].sum())} real rows")
    devices = (("gpu", dev), ("cpu", torch.device("cpu")))

    def grads_of(model):
        return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    def float64_step(device):
        model, step = mult_setup(device, discriminator, dropout=False)
        model.double()
        with _float64_losses():
            step(_as_float64(batches[0]))
        return grads_of(model)

    models, losses, grads = {}, {}, {}
    for label, device in devices:
        model, step = mult_setup(device, discriminator, dropout=False)
        losses[label] = []
        for b in batches[:3]:
            losses[label].append(float(step(b)["loss"]))
            grads.setdefault(label, grads_of(model))
        models[label] = (model, step)
    models["gpu"][0].load_state_dict(models["cpu"][0].state_dict())
    pad = {label: float(step(tail)["loss"]) for label, (_, step) in models.items()}
    grads64 = {label: float64_step(device) for label, device in devices}
    torch.backends.cudnn.enabled = False  # where the card's float32 error comes from
    try:
        model, step = mult_setup(dev, discriminator, dropout=False)
        step(batches[0])
        no_cudnn = grads_of(model)
    finally:
        torch.backends.cudnn.enabled = True
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    pad_rel = abs(pad["gpu"] - pad["cpu"]) / abs(pad["cpu"])
    err32 = _attention_grad_errors(grads["gpu"], grads["cpu"])
    err64 = _attention_grad_errors(grads64["gpu"], grads64["cpu"])
    exact = grads64["cpu"]
    tag = f"[mult check{' disc' if discriminator else ''}]"
    say(f"{tag} float32 losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative {rel} (tolerances {PHASE14_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); padded "
        f"tail of {MULT_BATCH - MULT_SAMPLES % MULT_BATCH} rows from the same weights: GPU "
        f"{pad['gpu']}, CPU {pad['cpu']} (relative {pad_rel:.3e}); TF32 off")
    say(f"{tag} step-1 gradients of {len(err64)} parameters, key biases against the whole "
        f"gradient's norm: float64 GPU vs CPU worst {max(err64.values()):.3e} of its norm "
        f"(tolerance {PHASE14_GRAD_TOL}), {_worst(err64)}; float32 GPU vs CPU worst "
        f"{max(err32.values()):.3e}, {_worst(err32)}; float32 against the CPU's float64: GPU "
        f"worst {max(_attention_grad_errors(grads['gpu'], exact).values()):.3e}, whole "
        f"{_whole_error(grads['gpu'], exact):.3e}; CPU worst "
        f"{max(_attention_grad_errors(grads['cpu'], exact).values()):.3e}, whole "
        f"{_whole_error(grads['cpu'], exact):.3e}; GPU with cuDNN off (the Conv1d "
        f"projections on ATen's kernels) worst "
        f"{max(_attention_grad_errors(no_cudnn, exact).values()):.3e}, whole "
        f"{_whole_error(no_cudnn, exact):.3e}; check {time.perf_counter() - t0:.1f} s")
    if rel[0] > PHASE14_LOSS_RTOL or pad_rel > PHASE14_LOSS_RTOL \
            or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"{tag} GPU and CPU losses differ: {rel}, padded {pad_rel}")
    if max(err64.values()) > PHASE14_GRAD_TOL:
        raise AssertionError(f"{tag} step-1 float64 gradients differ: {_worst(err64)}")
    return {"loss_rel": rel, "pad_loss_rel": pad_rel, "grad64_err": max(err64.values()),
            "grad32_err": max(err32.values())}


def phase_mult(dev, card: str, discriminator: bool, batches: list) -> dict:
    """Phase 14 (a): two passes of the generic train step over MulT's 27
    batches on the card (the second timed), no launch of either kernel; a
    profiled window of 8 steps; the GPU-vs-CPU check."""
    import torch

    _, step = mult_setup(dev, discriminator)
    reset_counts()
    seconds, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(b)["loss"] for b in batches]
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = read_counts()
    losses = [float(x) for x in losses]
    tag = f"[mult{' disc' if discriminator else ''}]"
    if not all(np.isfinite(losses)) or counts != {"fused_mlp": 0, "lstm": 0}:
        raise AssertionError(f"{tag} losses finite {all(np.isfinite(losses))}, launches {counts}")
    rate = MULT_SAMPLES / seconds[1]
    say_card(card, f"{tag} two passes of {len(batches)} generic train steps (B={MULT_BATCH}, "
             f"T={MULT_T}, {MULT_MODEL}): {seconds[0]:.3f} s and "
             f"{seconds[1]:.3f} s, pass-2 train samples/s {rate:.1f}; pass-2 mean loss "
             f"{np.mean(losses):.4f}; launches {counts}")
    window = batches[:8]
    profile = _profile_steps(card, f"{tag} profile", lambda: [step(b) for b in window],
                             len(window))
    if profile["counts"] != {"fused_mlp": 0, "lstm": 0}:
        raise AssertionError(f"{tag} kernels launched in the profiled steps")
    check = phase_mult_check(dev, discriminator, batches)
    return {"samples_per_s": rate, "seconds": seconds, "launches": counts,
            "profile": profile, "check": check}


def gcnet_batches(seed: int = SEED) -> list:
    """IEMOCAP-sized conversations from seeded normals: GCNET_DIALOGUES of T =
    110 with lengths in 20..110, two speakers, each utterance missing the
    modalities of one of the seven patterns (zeroed in the input, kept in
    the reconstruction target); batches of 16, the last 8 real rows and 8
    empty ones."""
    g = np.random.default_rng(seed)
    widths = [IEMOCAP_DIMS[m] for m in ("audio", "text", "video")]  # adim, tdim, vdim
    N, T = GCNET_DIALOGUES, GCNET_T
    lengths = g.integers(GCNET_LENGTHS[0], GCNET_LENGTHS[1] + 1, N).astype(np.int32)
    valid = np.arange(T)[None] < lengths[:, None]
    full = g.standard_normal((N, T, sum(widths)), dtype=np.float32) * valid[..., None]
    table = np.array([[m in p for m in "atv"] for p in IEMOCAP_PATTERNS], np.float32)
    present = table[g.integers(0, len(IEMOCAP_PATTERNS), (N, T))]  # (N, T, 3): a, t, v
    bounds = np.cumsum([0] + widths)
    features = full.copy()
    for k in range(3):
        features[..., bounds[k]:bounds[k + 1]] *= present[..., k:k + 1]
    data = {"features": features, "target": full, "present": present,
            "qmask": g.integers(0, 2, (N, T)).astype(np.int32) * valid,
            "labels": g.integers(0, GCNET_MODEL["n_classes"], (N, T)).astype(np.int32) * valid,
            "umask": valid.astype(np.float32), "lengths": lengths}
    batches = []
    for start in range(0, N, GCNET_BATCH):
        n = min(GCNET_BATCH, N - start)
        b = {}
        for k, v in data.items():
            b[k] = np.zeros((GCNET_BATCH,) + v.shape[1:], v.dtype)
            b[k][:n] = v[start:start + n]
        batches.append(b)
    return batches


def gcnet_setup(device, base: str = "LSTM", dropout: bool = True):
    """GCNet from the registry with seeded weights, and an Adam train step
    over the masked GCNet losses (cross-entropy over the valid utterances
    plus the reconstruction of the missing modalities)."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.models import build_module
    from mmtpu_torch.train.gcnet_loss import masked_ce_loss, masked_recon_loss
    from mmtpu_torch.train.step import apply_gradients, to_device

    a, t, v = (IEMOCAP_DIMS[m] for m in ("audio", "text", "video"))
    kw = dict(GCNET_MODEL, base_model=base, adim=a, tdim=t, vdim=v,
              **({} if dropout else {"dropout": 0.0}))
    model = common.init_model(build_module("gcnet", **kw), SEED, device)
    state = _adam_state(model)
    state.generator = common.use_run_generator(model, SEED, device)

    def step(batch: dict) -> torch.Tensor:
        b = to_device(batch, device)
        model.train()
        logits, rec, _ = model(b["features"], b["qmask"], b["umask"], b["lengths"])
        loss = masked_ce_loss(logits, b["labels"], b["umask"]) + masked_recon_loss(
            rec, b["target"], b["present"], b["umask"], a, t, v)
        apply_gradients(state, loss)
        return loss.detach()

    return model, step


def phase_gcnet_check(dev, base: str, batches: list) -> dict:
    """GCNet's first three train steps from the same seeded weights (dropout
    0, TF32 off) on the card and on the CPU: the losses, the step-1
    gradients against each parameter's norm, and the `lstm` launches of the
    card's first step (one forward)."""
    import torch

    t0 = time.perf_counter()
    _tf32_off()
    losses, grads, launches = {}, {}, None
    for label, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        model, step = gcnet_setup(device, base, dropout=False)
        losses[label] = []
        for i, b in enumerate(batches[:3]):
            reset_counts()
            losses[label].append(float(step(b)))
            if i == 0:
                grads[label] = {n: p.grad.detach().cpu().clone()
                                for n, p in model.named_parameters()}
                if label == "gpu":
                    launches = read_counts()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["gpu"], losses["cpu"])]
    errs = _grad_errors(grads["gpu"], grads["cpu"])
    want = {"fused_mlp": 0, "lstm": GCNET_LSTM_PER_FORWARD[base]}
    say(f"[gcnet check {base}] losses of steps 1-3, GPU {losses['gpu']}, CPU {losses['cpu']}: "
        f"relative {rel} (tolerances {PHASE14_LOSS_RTOL}, then {TRAIN_LATER_RTOL}); step-1 "
        f"gradients of {len(errs)} parameters: worst {max(errs.values()):.3e} of its norm "
        f"(tolerance {PHASE14_GRAD_TOL}), {_worst(errs)}; launches in step 1 {launches} "
        f"(derived {want}); TF32 off; check {time.perf_counter() - t0:.1f} s")
    if launches != want:
        raise AssertionError(f"[gcnet check {base}] launches {launches}, derived {want}")
    if rel[0] > PHASE14_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[gcnet check {base}] GPU and CPU losses differ: {rel}")
    if max(errs.values()) > PHASE14_GRAD_TOL:
        raise AssertionError(f"[gcnet check {base}] step-1 gradients differ: {_worst(errs)}")
    return {"loss_rel": rel, "grad_err": max(errs.values()), "launches": launches["lstm"]}


def _twin_check(dev, module, args, tag: str, launches: int, train: bool = False,
                bn_mask=None, float64: bool = False) -> dict:
    """A module's forward and one backward (seeded cotangents) on the card
    against its copy on the CPU from the same weights (TF32 off): the
    forward's max difference over the output's scale, each parameter's
    gradient (and each input's that requires one) against its norm, the
    `lstm` launches of the card's forward, and the BatchNorm running
    statistics after a train-mode forward. `float64`: module and inputs in
    float64 on both devices (for a module that runs no kernel)."""
    import copy

    import torch

    from mmtpu_torch.models.norm import batch_mask

    _tf32_off()
    cpu = torch.device("cpu")
    module.train(train)
    if float64:
        module.double()
        args = [x.double() if x is not None and x.is_floating_point() else x for x in args]
    twins = {"cpu": module, "gpu": copy.deepcopy(module).to(dev)}
    outs, grads, stats, seconds, counted, designs = {}, {}, {}, {}, None, None
    for label, m in twins.items():
        device = cpu if label == "cpu" else dev
        inputs = [None if x is None else x.detach().to(device).requires_grad_(x.requires_grad)
                  for x in args]
        t0 = time.perf_counter()
        reset_counts()
        mask = None if bn_mask is None else bn_mask.to(device)
        with batch_mask(mask):
            leaves = _output_leaves(m(*inputs))
        if label == "gpu":
            counted, designs = read_counts(), design_counts()
            count_wide(designs)
        gen = torch.Generator().manual_seed(SEED)
        cots = [torch.randn(x.shape, generator=gen).to(device) for x in leaves]
        sum((x * c).sum() for x, c in zip(leaves, cots)).backward()
        outs[label] = [x.detach().cpu().double() for x in leaves]
        grads[label] = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()
                        if p.grad is not None}
        grads[label].update({f"input {i}": x.grad.detach().cpu().clone()
                             for i, x in enumerate(inputs) if x is not None and x.requires_grad})
        stats[label] = {n: b.detach().cpu().double() for n, b in m.named_buffers()
                        if b.is_floating_point()}
        seconds[label] = time.perf_counter() - t0
    scale = max(max(x.abs().max().item() for x in outs["cpu"]), 1.0)
    fwd_err = max((a - b).abs().max().item() for a, b in zip(outs["gpu"], outs["cpu"])) / scale
    errs = _grad_errors(grads["gpu"], grads["cpu"])
    unreached = sorted(n for n, _ in module.named_parameters() if n not in grads["cpu"])
    stat_err = max([(stats["gpu"][n] - s).abs().max().item() / max(s.abs().max().item(), 1.0)
                    for n, s in stats["cpu"].items()] or [0.0])
    say(f"{tag}: forward max |GPU - CPU| {fwd_err:.3e} of the output's scale {scale:.3g} "
        f"(tolerance {TWIN_FWD_TOL}); gradients of {len(errs)} parameters: worst "
        f"{max(errs.values()):.3e} of its norm (tolerance {TWIN_GRAD_TOL}), {_worst(errs, 2)}"
        + (f"; running statistics {stat_err:.3e} of their scale" if stats["cpu"] else "")
        + (f"; no gradient reaches {unreached} on either device" if unreached else "")
        + f"; lstm launches in the forward {counted['lstm']} (derived {launches}; by "
        + f"design {designs}); "
        + ("float64" if float64 else "float32, TF32 off")
        + f"; GPU {seconds['gpu']:.2f} s, CPU {seconds['cpu']:.2f} s")
    if counted != {"fused_mlp": 0, "lstm": launches}:
        raise AssertionError(f"{tag}: launches {counted}, derived {launches}")
    if set(grads["gpu"]) != set(grads["cpu"]):
        raise AssertionError(f"{tag}: the devices' gradients reach different parameters")
    if fwd_err > TWIN_FWD_TOL or max(errs.values()) > TWIN_GRAD_TOL or stat_err > TWIN_FWD_TOL:
        raise AssertionError(f"{tag}: GPU and CPU differ: forward {fwd_err}, statistics "
                             f"{stat_err}, gradients {_worst(errs)}")
    return {"fwd_err": fwd_err, "grad_err": max(errs.values()), "stat_err": stat_err,
            "launches": counted["lstm"], "designs": designs, "unreached": unreached}


ATTENTION_B = 4  # dialogues in the lone MatchingAttention check


def phase_matching_attention(dev, batches: list) -> dict:
    """A lone MatchingAttention of each type at the fusion's width (memory
    and candidates 2·d_h = 600 from seeded normals, the utterance mask of
    GCNet's first 4 dialogues) forward and backward on the card against the
    CPU, the gradients of the memory and the candidates included (`dot` has
    no parameter). In float64 on both devices: no kernel runs here, and in
    float32 the 600-wide products of unit normals give logits of ~±25,
    whose rounding the softmax turns into ~2e-5 of the output on either
    device."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.models import build_module

    width = 2 * (2 * GCNET_MODEL["D_e"] + GCNET_MODEL["graph_hidden_size"])
    g = np.random.default_rng(SEED)
    mem = torch.from_numpy(g.standard_normal((ATTENTION_B, GCNET_T, width), dtype=np.float32))
    cand = torch.from_numpy(g.standard_normal((ATTENTION_B, GCNET_T, width), dtype=np.float32))
    umask = torch.from_numpy(batches[0]["umask"][:ATTENTION_B])
    results = {}
    for att in ("dot", "general", "general2", "concat"):
        kw = dict(mem_dim=width, cand_dim=width, att_type=att,
                  alpha_dim=GCNET_MODEL["graph_hidden_size"] if att == "concat" else None)
        module = common.init_model(build_module("matching_attention", **kw), SEED,
                                   torch.device("cpu"))
        args = [mem.clone().requires_grad_(), cand.clone().requires_grad_(), umask]
        results[att] = _twin_check(dev, module, args, f"[gcnet matching attention {att}]", 0,
                                   float64=True)
    return results


def phase_gcnet(dev, card: str) -> dict:
    """Phase 14 (b): GCNet's two epochs over the 8 batches on the card (the
    second timed; `lstm` exactly 6 per forward), a profiled window of 8
    steps, the GPU-vs-CPU checks with the LSTM and the GRU base (4 launches
    per forward), and the four MatchingAttention types alone."""
    import torch

    batches = gcnet_batches()
    _, step = gcnet_setup(dev)
    reset_counts()
    seconds, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(b) for b in batches]
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts, designs = read_counts(), design_counts()
    count_wide(designs)
    losses = [float(x) for x in losses]
    want = {"fused_mlp": 0, "lstm": 2 * len(batches) * GCNET_LSTM_PER_FORWARD["LSTM"]}
    # the base layers (H = D_e = 100) on the narrow design, the fusion
    # layers (H = 2·D_e + graph hidden = 300) on the cluster design
    want_designs = {"narrow": 2 * len(batches) * 2, "cluster": 2 * len(batches) * 4, "grid": 0}
    if not all(np.isfinite(losses)) or counts != want or designs != want_designs:
        raise AssertionError(f"[gcnet] losses finite {all(np.isfinite(losses))}, launches "
                             f"{counts} by design {designs}, derived {want}, {want_designs}")
    utterances = int(sum(int(b["lengths"].sum()) for b in batches))
    rates = {"conversations_per_s": GCNET_DIALOGUES / seconds[1],
             "utterances_per_s": utterances / seconds[1]}
    widths = " + ".join(str(IEMOCAP_DIMS[m]) for m in ("audio", "text", "video"))
    say_card(card, f"[gcnet] two epochs of {len(batches)} train steps (B={GCNET_BATCH}, T="
             f"{GCNET_T}, {GCNET_DIALOGUES} dialogues, {utterances} utterances; widths {widths}"
             f", D_e {GCNET_MODEL['D_e']}, graph {GCNET_MODEL['graph_hidden_size']}): "
             f"{seconds[0]:.3f} s and {seconds[1]:.3f} s; "
             f"epoch 2: {rates['conversations_per_s']:.1f} conversations/s, "
             f"{rates['utterances_per_s']:.1f} utterances/s; epoch-2 mean loss "
             f"{np.mean(losses):.4f}; launches {counts} (derived {want}), lstm by design "
             f"{designs}")
    window = batches[:GCNET_PROFILE_STEPS]
    profile = _profile_steps(card, "[gcnet profile]", lambda: [step(b) for b in window],
                             len(window))
    if profile["counts"]["lstm"] != len(window) * GCNET_LSTM_PER_FORWARD["LSTM"]:
        raise AssertionError(f"[gcnet] profiled launches {profile['counts']}")
    checks = {base: phase_gcnet_check(dev, base, batches) for base in ("LSTM", "GRU")}
    attention = phase_matching_attention(dev, batches)
    return {**rates, "seconds": seconds, "launches": counts, "designs": designs,
            "profile": profile, "checks": checks, "attention": attention}


def phase_ef(dev, card: str) -> dict:
    """Phase 14 (c): EFModelAL with its LSTMClassifier at the IEMOCAP widths
    forward and backward on the card against the CPU (dropouts 0, TF32
    off), in train mode under a batch mask whose last 28 rows are padding
    (the pad-aware BatchNorm's running statistics held too); `lstm` exactly
    2 per forward; the card's forward-and-backward time."""
    import torch

    from mmtpu_torch.cli import common
    from mmtpu_torch.models.fc import FcClassifier
    from mmtpu_torch.models.lstm import LSTMClassifier
    from mmtpu_torch.models.norm import batch_mask
    from mmtpu_torch.models.seq_extras import EFModelAL

    a, t = IEMOCAP_DIMS["audio"], IEMOCAP_DIMS["text"]
    model = EFModelAL(FcClassifier(a, [128], 128, dropout=0.0),
                      LSTMClassifier(t, 128, 128, 4, dropout_rate=0.0),
                      out_dim_a=128, out_dim_v=128, fusion_size=128, num_class=4, dropout=0.0)
    model = common.init_model(model, SEED, torch.device("cpu"))
    g = np.random.default_rng(SEED)
    real = EF_B - EF_PAD_ROWS
    lengths = np.zeros(EF_B, np.int64)
    lengths[:real] = g.integers(IEMOCAP_FRAMES[0], EF_T + 1, real)
    mask = (np.arange(EF_T)[None, :, None] < lengths[:, None, None]) \
        * np.ones((1, 1, t), np.float32)
    acoustic = g.standard_normal((EF_B, a), dtype=np.float32)
    lexical = g.standard_normal((EF_B, EF_T, t), dtype=np.float32) * mask
    sample_mask = (np.arange(EF_B) < real).astype(np.float32)
    args = [torch.from_numpy(x) for x in (acoustic, lexical, mask)]
    result = _twin_check(dev, model, args, "[ef] EFModelAL + LSTMClassifier (train mode, "
                         f"{EF_PAD_ROWS} padded rows)", EF_LSTM_PER_FORWARD, train=True,
                         bn_mask=torch.from_numpy(sample_mask))
    gpu = model.to(dev)
    on_card = [x.to(dev) for x in args]
    card_mask = torch.from_numpy(sample_mask).to(dev)

    def forward_backward():
        with batch_mask(card_mask):
            out, feat = gpu(*on_card)
        (out.sum() + feat.sum()).backward()

    ms = event_ms(forward_backward, iters=10, repeats=3, warmup=2)
    say_card(card, f"[ef] forward and backward at B={EF_B}, T={EF_T}, text {t} → 2 × "
             f"bi-LSTM 128: {ms:.3f} ms (events)")
    return {**result, "ms": ms}


def say_phase14(card: str, mult: Optional[dict], gcnet: Optional[dict], ef: Optional[dict],
                seconds: float) -> None:
    parts = []
    if mult:
        parts.append("MulT " + ", ".join(
            f"{kind} {r['samples_per_s']:.1f} train samples/s (busy share "
            f"{r['profile']['busy_share']:.3f}, {r['profile']['kernels_per_step']:.0f} kernels "
            f"per step)" for kind, r in mult.items()))
    if gcnet:
        parts.append(f"GCNet {gcnet['conversations_per_s']:.1f} conversations/s, "
                     f"{gcnet['utterances_per_s']:.1f} utterances/s (busy share "
                     f"{gcnet['profile']['busy_share']:.3f}), lstm {gcnet['launches']['lstm']}")
    if ef:
        parts.append(f"EFModelAL forward+backward {ef['ms']:.3f} ms, lstm {ef['launches']} per "
                     "forward")
    say_card(card, "[summary] phase 14: " + "; ".join(parts) + f"; phase {seconds:.1f} s")


def phase14(dev, card: str, mult: bool = True, gcnet: bool = True, ef: bool = True) -> dict:
    out = {"mult": None, "gcnet": None, "ef": None}
    t0 = time.perf_counter()
    if mult:
        batches = mult_batches()
        out["mult"] = {kind: phase_mult(dev, card, kind == "discriminator", batches)
                       for kind in ("plain", "discriminator")}
    t1 = time.perf_counter()
    if gcnet:
        out["gcnet"] = phase_gcnet(dev, card)
    t2 = time.perf_counter()
    if ef:
        out["ef"] = phase_ef(dev, card)
    say(f"[phase 14] MulT {t1 - t0:.1f} s, GCNet {t2 - t1:.1f} s, EFModelAL "
        f"{time.perf_counter() - t2:.1f} s")
    return out


# Phase 15: the device-resident epoch and the stacked folds/runs engine.
MEMBER_MLP_CASES = ((2, 128), (3, 128), (2, 1024), (3, 1024))  # (K members, B) at HEAD_DIMS
MEMBER_LSTM_CASES = ((3, 2, 32, 50, 64), (5, 2, 32, 50, 64))  # (K, G, B, T, H): K·G = 6, 10
RESIDENT_RTOL = 1e-5  # resident vs streaming epoch losses, same weights, cuDNN deterministic
STACK_RTOL = (1e-4, 1e-3)  # stacked vs sequential train losses, step 1 and steps 2-3 (the
# earlier phases' GPU-vs-CPU rule); epoch losses are reported beside them: over a whole
# epoch Adam turns the grouped convolutions' rounding near g = 0 into ±lr steps
TEACHER_RTOL = (1e-4, 1e-3)  # a teacher-forced stacked step vs its sequential step: the
# loss; the update (parameters after minus before) and Adam's first moment, by global norm
STACKED_RUNS = (3, 5)  # --stacked-runs on UttFusion: 6 and 10 lstm groups per launch
MARGIN = 1e-3  # a prediction whose top-2 logit gap is below this may flip between two runs


def phase_kernels_members(dev) -> dict:
    """Phase 2, the member axis: `fused_mlp` with K members' weights and
    `lstm` with K·G groups, each called as the stacked engine calls it
    (under `torch.func.vmap`, one launch), against their plain versions (the
    member-axis chain; the scan over the K·G groups), timed as the other
    kernel rows are."""
    import torch
    from torch.func import vmap

    from mmtpu_torch.ops import fused_mlp, lstm_sequence_stacked, lstm_stacked_reference
    from mmtpu_torch.ops.fused_mlp import fused_mlp_members_reference

    g = torch.Generator().manual_seed(SEED + 15)
    dims, n = HEAD_DIMS, len(HEAD_DIMS) - 1
    stacked_mlp = vmap(lambda x, *p: fused_mlp(x, p[:n], p[n:]))
    mlp, max_err = {}, 0.0
    for K, B in MEMBER_MLP_CASES:
        x = torch.randn(K, B, dims[0], generator=g).to(dev)
        ws = [(torch.randn(K, o, i, generator=g) / i ** 0.5).to(dev)
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [(0.1 * torch.randn(K, o, generator=g)).to(dev) for o in dims[1:]]

        @torch.no_grad()
        def kernel():
            return stacked_mlp(x, *ws, *bs)

        def plain():
            return fused_mlp_members_reference(x, ws, bs)

        before = fused_mlp.launches
        got = kernel()
        launches = fused_mlp.launches - before
        err = (got - plain()).abs().max().item()
        label = f"fused_mlp K={K} B={B} {dims}"
        say(f"[kernels] {label} under vmap: {launches} launch, max |kernel - plain| {err:.3e}")
        if launches != 1 or got.shape != (K, B, dims[-1]) or err > KERNEL_TOL:
            raise AssertionError(f"{label}: {launches} launches, shape {tuple(got.shape)}, "
                                 f"error {err}")
        max_err = max(max_err, err)
        p1, k1, k2, p2 = (event_ms(f) for f in (plain, kernel, kernel, plain))
        kd = own_device_ms(kernel, "fused_mlp")
        pd = device_breakdown(lambda: [plain() for _ in range(100)])["device_ms"] / 100
        params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
        bound, bound_by = _bound(4 * K * (B * dims[0] + params + B * dims[-1]),
                                 2 * K * B * sum(i * o for i, o in zip(dims[:-1], dims[1:])))
        mlp[(K, B)] = {"ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
                       "device_ms": kd, "plain_device_ms": pd, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": None, "max_abs_err": err}
        say(f"[kernels] {label}: per call kernel {k1:.4f}/{k2:.4f} ms, plain (batched chain) "
            f"{p1:.4f}/{p2:.4f} ms (events); device time kernel {kd} ms, plain {pd} ms "
            f"(profiler); bound {bound:.6f} ms ({bound_by})")

    lstm = {}
    for seed, (K, G, B, T, H) in enumerate(MEMBER_LSTM_CASES):
        xw, wh, _, _, _ = _lstm_inputs(dev, K * G, B, T, H, False, False, 150 + seed)
        xw, wh = xw.view(K, G, B, T, 4 * H), wh.view(K, G, H, 4 * H)
        stacked_lstm = vmap(lambda a, w: lstm_sequence_stacked(a, w)[0])

        @torch.no_grad()
        def kernel():
            return stacked_lstm(xw, wh)

        def plain():
            return lstm_stacked_reference(xw.view(K * G, B, T, 4 * H),
                                          wh.view(K * G, H, 4 * H))[0]

        before = lstm_sequence_stacked.launches
        got = kernel()
        launches = lstm_sequence_stacked.launches - before
        err = (got.reshape(K * G, B, T, H) - plain()).abs().max().item()
        label = f"lstm K={K} × G={G} (K·G={K * G}) B={B} T={T} H={H}"
        say(f"[kernels] {label} under vmap: {launches} launch, max |kernel - plain| {err:.3e}")
        if launches != 1 or err > KERNEL_TOL:
            raise AssertionError(f"{label}: {launches} launches, error {err}")
        max_err = max(max_err, err)
        slow = dict(iters=10, repeats=3, warmup=2)
        p1, k1, k2, p2 = (event_ms(plain, **slow), event_ms(kernel), event_ms(kernel),
                          event_ms(plain, **slow))
        kd = own_device_ms(kernel, "lstm")
        pd = device_breakdown(lambda: [plain() for _ in range(3)])["device_ms"] / 3
        bound, bound_by = lstm_bound_ms(K * G, B, T, H)
        library, ours, diff = _lstm_library(dev, K * G, B, T, H, 150 + seed)
        if diff > LIBRARY_TOL:
            raise AssertionError(f"{label}: nn.LSTM differs by {diff}")
        l1, o1, l2 = event_ms(library), event_ms(ours), event_ms(library)
        lstm[(K, G, B, T, H)] = {
            "ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
            "device_ms": kd, "plain_device_ms": pd, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": statistics.mean([l1, l2]), "with_projection_ms": o1,
            "max_abs_err": err, "serial_steps": T}
        say(f"[kernels] {label}: per call kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
            f"ms (events); device time kernel {kd} ms, plain {pd} ms (profiler); bound "
            f"{bound:.6f} ms ({bound_by}); nn.LSTM ×{K * G} (projection included) "
            f"{l1:.4f}/{l2:.4f} ms vs projection + kernel {o1:.4f} ms")
    return {"mlp": mlp, "lstm": lstm, "max_err": max_err}


@contextlib.contextmanager
def _loops(mode: Optional[str], seen: list):
    """Every `TrainLoop` a driver builds inside the `with` body is appended
    to `seen`, and takes `device_resident=mode` unless `mode` is None (the
    driver's own choice, mmtpu's default "auto")."""
    from mmtpu_torch.train import loop as loop_mod

    real = loop_mod.TrainLoop

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            if mode is not None:
                kwargs["device_resident"] = mode
            super().__init__(*args, **kwargs)
            seen.append(self)

    loop_mod.TrainLoop = Recorded
    try:
        yield
    finally:
        loop_mod.TrainLoop = real


def _epoch_losses(metrics: Path) -> list:
    """(train, validation) loss per epoch of an epoch_metrics.json."""
    return [(e["train"]["loss"], e["validation"]["loss"])
            for e in json.loads((metrics / "epoch_metrics.json").read_text()) if "epoch" in e]


def _loss_rel(got: list, want: list) -> list:
    """Per epoch the largest relative difference of the two losses."""
    return [max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(g, w))
            for g, w in zip(got, want)]


@contextlib.contextmanager
def _train_step_losses(seq: list, stk: list):
    """The train losses of every step inside the `with` body: per resident
    epoch of a sequential run its (steps,) losses into `seq`, per stacked
    step its (K,) losses (left on the device until the body ends) into
    `stk`."""
    from mmtpu_torch.train import device_loop as dl
    from mmtpu_torch.train.stacked import StackedModel

    real_epoch, real_step = dl.run_train_epoch, StackedModel.train_step

    def epoch(*args, **kwargs):
        outs = real_epoch(*args, **kwargs)
        seq.append([float(v) for v in outs["loss"]])
        return outs

    def step(self, *args, **kwargs):
        out = real_step(self, *args, **kwargs)
        stk.append(out["loss"])
        return out

    dl.run_train_epoch, StackedModel.train_step = epoch, step
    try:
        yield
    finally:
        dl.run_train_epoch, StackedModel.train_step = real_epoch, real_step
        stk[:] = [v.tolist() for v in stk]


def _first_steps_rel(seq: list, stk: list, member: int, steps: int = 3) -> list:
    """Relative difference of member's first `steps` train losses, stacked
    (stk: per step K losses) vs its sequential run (seq: its first epoch)."""
    return [abs(stk[t][member] - seq[t]) / max(abs(seq[t]), 1e-12) for t in range(steps)]


def _check_first_steps(tag: str, rel: list) -> None:
    worst = [max(r[0] for r in rel), max(max(r[1:]) for r in rel)]
    if worst[0] > STACK_RTOL[0] or worst[1] > STACK_RTOL[1]:
        raise AssertionError(f"{tag} first train steps' losses differ from the sequential "
                             f"runs': {rel} (tolerances {STACK_RTOL}: step 1, steps 2-3)")


def _train_snapshot(state) -> dict:
    """A sequential run's parameters and buffers, its optimizer's state by
    parameter name, its step count and lr scale, cloned."""
    opt = state.optimizer
    scales = {g["lr"] / g["base_lr"] for g in opt.param_groups}
    if len(scales) != 1:
        raise AssertionError(f"the optimizer's groups have lr scales {scales}")
    named = dict(state.model.named_parameters())
    moments, counts = {}, set()
    for n, p in named.items():
        st = opt.state.get(p, {})
        moments[n] = {k: v.detach().clone() for k, v in st.items()
                      if getattr(v, "shape", None) == p.shape}
        counts.add(int(st.get("step", 0)))
    if len(counts) != 1:
        raise AssertionError(f"the optimizer's parameters have step counts {counts}")
    return {"params": {n: p.detach().clone() for n, p in named.items()},
            "buffers": {n: b.detach().clone() for n, b in state.model.named_buffers()},
            "moments": moments, "count": counts.pop(), "lr_scale": scales.pop()}


@contextlib.contextmanager
def _teacher_capture(at: tuple, seq: list, stk: list):
    """Inside the `with` body, at each train step index in `at` (counted from
    0 over a run's train steps, epochs included): a sequential run's step
    (`train_step_core` on the resident path) appends to its record in `seq`
    (one dict per run, in order) its snapshot before the step, its batch, its
    loss and its parameters and optimizer state after; a stacked run's step
    appends (step index, `StackedModel`, host batch) to `stk`. Every record
    also counts its run's train steps under "steps"."""
    from mmtpu_torch.train import device_loop as dl
    from mmtpu_torch.train.stacked import StackedModel

    real_core, real_step = dl.train_step_core, StackedModel.train_step
    runs, stk_steps = {}, {}

    def core(task, state, batch, padded=True):
        if id(state) not in runs:  # the entry keeps the state alive: its id is not reused
            runs[id(state)] = (state, {"steps": 0})
            seq.append(runs[id(state)][1])
        rec = runs[id(state)][1]
        step, rec["steps"] = rec["steps"], rec["steps"] + 1
        if step not in at:
            return real_core(task, state, batch, padded)
        before = _train_snapshot(state)
        out = real_core(task, state, batch, padded)
        rec[step] = {"before": before, "after": _train_snapshot(state), "loss": float(out[0]),
                     "batch": {k: v.detach().cpu().numpy() for k, v in batch.items()}}
        return out

    def step(self, host_batch, device):
        i = stk_steps.get(id(self), 0)
        stk_steps[id(self)] = i + 1
        if i in at:
            stk.append((i, self, {k: np.array(v) for k, v in host_batch.items()}))
        return real_step(self, host_batch, device)

    dl.train_step_core, StackedModel.train_step = core, step
    try:
        yield
    finally:
        dl.train_step_core, StackedModel.train_step = real_core, real_step


def _norm_rel(got: dict, want: dict, base: dict) -> float:
    """‖got − want‖ / ‖want − base‖ over every tensor of the dicts (base
    None: ‖got − want‖ / ‖want‖)."""
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float(((w - (0 if base is None else base[n])) ** 2).sum()) for n, w in want.items())
    return (num / max(den, 1e-30)) ** 0.5


def _load_members(stacked, snaps: list) -> None:
    """Member k of `stacked` set to snapshot k's state before its step:
    parameters, buffers, the optimizer's state, step count and lr scale."""
    import torch

    opt = stacked.optimizer
    with torch.no_grad():
        for n, p in stacked.params.items():
            p.copy_(torch.stack([s["before"]["params"][n] for s in snaps]))
        for n, b in stacked.buffers.items():
            b.copy_(torch.stack([s["before"]["buffers"][n] for s in snaps]))
        for n, st in opt.state.items():
            for key, v in st.items():
                v.copy_(torch.stack([s["before"]["moments"][n][key] for s in snaps]))
        opt.count.copy_(torch.tensor([s["before"]["count"] for s in snaps]))
        opt.lr_scale.copy_(torch.tensor([s["before"]["lr_scale"] for s in snaps]))


def _first_moment(opt) -> str:
    return next(iter(opt.STATE[opt.kind]))


def _member_rows(stacked, losses: list, refs: list, snaps: list) -> list:
    """Per member the relative difference of the stacked step's loss, update
    and first moment from a reference step's ({"loss", "params", "moment"})
    taken from the same state."""
    opt = stacked.optimizer
    first = _first_moment(opt)
    rows = []
    for k, (ref, snap) in enumerate(zip(refs, snaps)):
        params = {n: p[k] for n, p in stacked.params.items()}
        moment = {n: st[first][k] for n, st in opt.state.items()}
        rows.append({"loss": abs(losses[k] - ref["loss"]) / max(abs(ref["loss"]), 1e-12),
                     "update": _norm_rel(params, ref["params"], snap["before"]["params"]),
                     "moment": _norm_rel(moment, ref["moment"], None)})
    return rows


def _float64_states(stacked, snaps: list) -> list:
    """Per member a float64 `TrainState` at its snapshot's state before the
    step: a copy of the member's model, and a torch optimizer of the same
    class and groups holding the snapshot's moments, step count and lr."""
    import copy

    import torch

    from mmtpu_torch.train.state import TrainState

    if stacked.optimizer.kind not in ("adam", "adamw"):
        raise AssertionError(f"float64 teacher forcing takes Adam, not {stacked.optimizer.kind}")
    states = []
    for src, snap in zip(stacked.states, snaps):
        model = copy.deepcopy(src.model).double()
        named = dict(model.named_parameters())
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(snap["before"]["params"][n])
            for n, b in model.named_buffers():
                b.copy_(snap["before"]["buffers"][n])
        names = {id(p): n for n, p in src.model.named_parameters()}
        own = {id(p): n for n, p in named.items()}
        opt = type(src.optimizer)([
            {**{k: v for k, v in g.items() if k != "params"},
             "lr": g["base_lr"] * snap["before"]["lr_scale"],
             "params": [named[names[id(p)]] for p in g["params"]]}
            for g in src.optimizer.param_groups])
        for g in opt.param_groups:
            on_device = g.get("fused") or g.get("capturable")  # torch keeps the step there
            for p in g["params"]:
                n = own[id(p)]
                opt.state[p] = {
                    "step": torch.tensor(float(snap["before"]["count"]),
                                         device=p.device if on_device else None),
                    **{k: v.double() for k, v in snap["before"]["moments"][n].items()}}
        states.append(TrainState(model, opt, clip=src.clip))
    return states


def _float64_steps(stacked, snaps: list, host_batch: dict, dev) -> tuple:
    """The step from the snapshots' states in float64, once through the
    sequential path (`train_step_core`, member by member) and once through
    a float64 twin of `stacked`: (stacked twin, its losses, the sequential
    references)."""
    import copy

    from mmtpu_torch.train.stacked import StackedModel
    from mmtpu_torch.train.step import has_padded_rows, to_device, train_step_core

    host = _as_float64(host_batch)
    task = copy.copy(stacked.task)
    first = _first_moment(stacked.optimizer)
    refs = []
    with _float64_losses():
        for k, st in enumerate(_float64_states(stacked, snaps)):
            member = {key: v[k] for key, v in host.items()}
            task.model = st.model
            loss, _, _ = train_step_core(task, st, to_device(member, dev),
                                         has_padded_rows(member))
            named = dict(st.model.named_parameters())
            refs.append({"loss": float(loss),
                         "params": {n: p.detach() for n, p in named.items()},
                         "moment": {n: st.optimizer.state[p][first] for n, p in named.items()}})
        states = _float64_states(stacked, snaps)
        task.model = states[0].model
        twin = StackedModel(task, states)
        _load_members(twin, snaps)
        losses = twin.train_step(host, dev)["loss"].tolist()
    return twin, losses, refs


def _teacher_forced(tag: str, stacked, step: int, host_batch: dict, recs: list, dev,
                    float64: bool = False) -> dict:
    """Member k of `stacked` set to sequential run k's state before train
    step `step` (`_load_members`), then one stacked step on the stacked
    run's own batch of that step; its loss, update and Adam's first moment
    against the sequential step's, per member. The batch's real rows must
    equal the sequential step's. Held to TEACHER_RTOL in float32, or, with
    `float64` (a BatchNorm path: in float32 either path misses the exact
    gradient by ~1e-3 of its norm, phase 5), the float32 loss and then the
    same step from the same states in float64 on both paths."""
    snaps = [r[step] for r in recs]
    keep = np.asarray(host_batch["sample_mask"]) > 0
    for k, snap in enumerate(snaps):
        diff = [key for key, v in snap["batch"].items() if key in host_batch
                and not np.array_equal(v[keep[k]], np.asarray(host_batch[key][k])[keep[k]])]
        if diff or not keep[k].any():
            raise AssertionError(f"{tag} step {step}: member {k}'s batch differs from its "
                                 f"sequential run's in {diff} ({int(keep[k].sum())} real rows)")
    _load_members(stacked, snaps)
    losses = stacked.train_step(host_batch, dev)["loss"].tolist()
    first = _first_moment(stacked.optimizer)
    refs = [{"loss": s["loss"], "params": s["after"]["params"],
             "moment": {n: m[first] for n, m in s["after"]["moments"].items()}} for s in snaps]
    out = {"float32": _member_rows(stacked, losses, refs, snaps)}
    if float64:
        out["float64"] = _member_rows(*_float64_steps(stacked, snaps, host_batch, dev), snaps)

    def show(rows):
        return (f"the loss {[r['loss'] for r in rows]}, the update {[r['update'] for r in rows]}, "
                f"the first moment {[r['moment'] for r in rows]}")

    say(f"{tag} teacher-forced step {step + 1} ({int(keep[0].sum())} real rows, lr scales "
        f"{[s['before']['lr_scale'] for s in snaps]}, Adam counts "
        f"{[s['before']['count'] + 1 for s in snaps]}): per member relative difference, "
        f"float32 {show(out['float32'])}"
        + (f"; float64 {show(out['float64'])}" if float64 else "")
        + f" (tolerances {TEACHER_RTOL})")
    held = out["float64"] if float64 else out["float32"]
    worst = [max(r["loss"] for r in out["float32"] + held),
             max(max(r["update"], r["moment"]) for r in held)]
    if worst[0] > TEACHER_RTOL[0] or worst[1] > TEACHER_RTOL[1]:
        raise AssertionError(f"{tag} teacher-forced step {step + 1} differs from the "
                             f"sequential step: {out} (tolerances {TEACHER_RTOL})")
    return out


def _check_teacher(tag: str, seq: list, stk: list, at: tuple, steps: int, dev,
                   float64: bool = False) -> dict:
    """Every sequential run took `steps` train steps; each stacked run's
    captured steps teacher-forced against the first K sequential runs."""
    if [r["steps"] for r in seq] != [steps] * len(seq):
        raise AssertionError(f"{tag} sequential runs took {[r['steps'] for r in seq]} train "
                             f"steps, expected {steps} each")
    if sorted(i for i, _, _ in stk) != sorted(at * (len(stk) // len(at))) or not stk:
        raise AssertionError(f"{tag} stacked steps captured {[i for i, _, _ in stk]}")
    return {(st.k, i): _teacher_forced(f"{tag} K={st.k}", st, i, batch, seq[:st.k], dev,
                                       float64)
            for i, st, batch in stk}


def _test_logits(loop, dev) -> "torch.Tensor":
    """The loop's model (its best, as test() restored it) over the test
    split's batches as the loader forms them, eval mode."""
    import torch

    from mmtpu_torch.train.step import output_logits, to_device

    out = []
    with torch.no_grad():
        for batch in loop.loaders["test"]:
            keep = torch.from_numpy(batch["sample_mask"] > 0)
            logits = output_logits(loop.task.apply(to_device(batch, dev), train=False))
            out.append(logits.float().cpu()[keep])
    return torch.cat(out)


def _cudnn(deterministic: bool) -> None:
    import torch

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False


def phase_resident(dev, card: str, work: Path) -> dict:
    """Phase 15 (a): phase 5's scratch fine-tune (ResNet18/34, batch 128,
    2048/512/512, 2 epochs) through `train_multimodal.main` on the
    device-resident path the driver's default ("auto", its budget admitting
    all three splits) and again streaming ("off"), from the same seed, cuDNN
    deterministic, TF32 off: epoch losses within 1e-5, test predictions
    equal where the top-2 margin is clear, `fused_mlp` exactly once per
    fused eval step (once per batch streaming), epoch-2 samples/s and the
    busy share of one more profiled train epoch of each."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "resident"
    cfg = train_configs(str(out_root))["scratch"]
    _cudnn(True)
    fused = _eval_batches(TRAIN_SAMPLES, TRAIN_BATCH)
    plain = _eval_batches(TRAIN_SAMPLES, TRAIN_BATCH, fused=False)
    want = {mode: TRAIN_EPOCHS * b["validation"] + b["test"]
            for mode, b in (("on", fused), ("off", plain))}
    runs, loops, launches = {}, {}, {}
    try:
        for mode in ("off", "on"):
            name = f"{SCRATCH_NAME}_Resident_{mode}"
            cfg["experiment"]["name"] = cfg["model"]["name"] = name
            path = work / f"resident_{mode}.json"
            path.write_text(json.dumps(cfg))
            seen = []
            reset_counts()
            with _loops(None if mode == "on" else mode, seen):
                runs[mode] = _run_cli(train_multimodal, path, f"[resident {mode}]", out_root,
                                      name)
            launches[mode] = read_counts()
            loops[mode] = seen[0]
            admitted = sorted(loops[mode]._resident)
            if launches[mode] != {"fused_mlp": want[mode], "lstm": 0} or admitted != (
                    ["test", "train", "validation"] if mode == "on" else []):
                raise AssertionError(f"[resident {mode}] launches {launches[mode]}, expected "
                                     f"fused_mlp {want[mode]}; resident splits {admitted}")
            runs[mode]["metrics"] = out_root / name / "metrics" / "1"
    finally:
        _cudnn(False)
    rel = _loss_rel(_epoch_losses(runs["on"]["metrics"]), _epoch_losses(runs["off"]["metrics"]))
    if max(rel) > RESIDENT_RTOL:
        raise AssertionError(f"[resident] epoch losses differ from streaming: {rel}")
    logits = {mode: _test_logits(loops[mode], dev) for mode in ("off", "on")}
    top2 = logits["off"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > MARGIN
    flips = int((logits["on"].argmax(-1) != logits["off"].argmax(-1))[clear].sum())
    if flips:
        raise AssertionError(f"[resident] {flips} test predictions with a clear margin differ")
    busy = {}
    for mode, loop in loops.items():
        brk = device_breakdown(lambda: loop.train_epoch(TRAIN_EPOCHS + 1))
        loop.recorder.reset()
        busy[mode] = brk["device_ms"] / brk["profiled_wall_ms"]
    for mode in ("off", "on"):
        say_card(card, f"[resident {mode}] epoch {TRAIN_EPOCHS} train "
                 f"{runs[mode]['epoch_s']:.3f} s = {runs[mode]['samples_per_s']:.1f} samples/s "
                 f"(B={TRAIN_BATCH}); busy share of a profiled train epoch {busy[mode]:.3f}; "
                 f"fused_mlp launches {launches[mode]['fused_mlp']} (eval steps per split "
                 f"{fused if mode == 'on' else plain}); peak device memory "
                 f"{runs[mode]['peak_bytes'] / 2**20:.1f} MiB")
    say(f"[resident] epoch losses resident vs streaming, largest relative difference per "
        f"epoch {rel} (tolerance {RESIDENT_RTOL}); test predictions equal on "
        f"{int(clear.sum())} of {clear.numel()} rows with a top-2 margin above {MARGIN}")
    return {"runs": runs, "launches": launches, "busy": busy, "loss_rel": rel,
            "eval_steps": fused}


@contextlib.contextmanager
def _channels_last(on: bool = True):
    """With `on`, every `TrainLoop` built inside the `with` body holds its
    model's 4-D weights in channels_last, so cuDNN (deterministic still)
    runs the convolutions with its NHWC algorithms: the same arithmetic,
    summed in another order."""
    import torch

    from mmtpu_torch.train import loop as loop_mod

    real = loop_mod.TrainLoop

    class ChannelsLast(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.state.model.to(memory_format=torch.channels_last)

    loop_mod.TrainLoop = ChannelsLast if on else real
    try:
        yield
    finally:
        loop_mod.TrainLoop = real


@contextlib.contextmanager
def _native_convolutions(on: bool = True):
    """With `on`, cuDNN off inside the `with` body: PyTorch's own
    convolutions. UttFusion has no other cuDNN operation (its LSTMs are the
    `lstm` kernel, its classifier has no BatchNorm), so only the
    convolutions' algorithm changes."""
    import torch

    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = not on
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def phase_stacked_folds(dev, card: str, work: Path) -> dict:
    """Phase 15 (b): two-fold CV of phase 5's scratch fine-tune (dropout 0:
    a stacked member's masks are not its sequential run's) sequentially and
    with `--stacked-folds`, cuDNN deterministic: each fold's first three
    train steps within 1e-4 (step 1) and 1e-3 (steps 2-3) of the sequential
    fold's; epoch 1's last step and epoch 2's first teacher-forced (each
    fold set to its sequential run's state before the step) within
    TEACHER_RTOL; the epoch losses beside them, and beside those the
    sequential CV's own spread when run again with its convolutions in
    cuDNN's NHWC algorithms (`_channels_last`, still deterministic); the
    same `{split}_metrics_agg.json` keys, `fused_mlp`
    exactly once per stacked eval step for both folds."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "stacked_folds"
    cfg = train_configs(str(out_root))["scratch"]
    cfg["model"]["dropout"] = 0.0
    cfg["experiment"]["cross_validation"] = 2
    n_train = -(-TRAIN_SAMPLES["train"] // TRAIN_BATCH)
    at = (n_train - 1, n_train)  # epoch 1's last train step, epoch 2's first
    steps = {"seq": _eval_batches(TRAIN_SAMPLES, TRAIN_BATCH),
             "stk": _eval_batches(TRAIN_SAMPLES, TRAIN_BATCH, fused=False)}
    steps["alg"] = steps["seq"]
    want = {kind: (2 if kind != "stk" else 1)
            * (TRAIN_EPOCHS * b["validation"] + b["test"]) for kind, b in steps.items()}
    runs, steps_seq, steps_stk, seq_caps, stk_caps = {}, [], [], [], []
    for kind, extra in (("seq", ()), ("stk", ("--stacked-folds",)), ("alg", ())):
        name = f"{SCRATCH_NAME}_CV_{kind}"
        cfg["experiment"]["name"] = cfg["model"]["name"] = name
        path = work / f"folds_{kind}.json"
        path.write_text(json.dumps(cfg))
        reset_counts()
        t0 = time.perf_counter()
        _cudnn(True)
        try:
            with contextlib.ExitStack() as hooks:
                hooks.enter_context(_channels_last(kind == "alg"))
                if kind != "alg":
                    hooks.enter_context(_train_step_losses(steps_seq, steps_stk))
                    hooks.enter_context(_teacher_capture(at, seq_caps, stk_caps))
                rc = train_multimodal.main(["--config", str(path), "--run_id", "1", *extra])
        finally:
            _cudnn(False)
        if rc != 0:
            raise AssertionError(f"[stacked folds {kind}] non-zero exit")
        seconds = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"fused_mlp": want[kind], "lstm": 0}:
            raise AssertionError(f"[stacked folds {kind}] launches {counts}, expected "
                                 f"fused_mlp {want[kind]}")
        metrics = out_root / name / "metrics" / "1"
        runs[kind] = {"seconds": seconds, "launches": counts, "metrics": metrics,
                      "losses": [_epoch_losses(metrics / f"fold_{f}") for f in (1, 2)],
                      "agg": {s: json.loads((metrics / f"{s}_metrics_agg.json").read_text())
                              for s in ("train", "validation", "test")},
                      "epoch_s": [json.loads((metrics / f"fold_{f}/epoch_metrics.json")
                                             .read_text())[TRAIN_EPOCHS - 1]["train"]["timing"]
                                  ["total_time"] for f in (1, 2)]}
    rel = [_loss_rel(a, b) for a, b in zip(runs["stk"]["losses"], runs["seq"]["losses"])]
    worst = [max(r[e] for r in rel) for e in range(TRAIN_EPOCHS)]
    alg = [_loss_rel(a, b) for a, b in zip(runs["alg"]["losses"], runs["seq"]["losses"])]
    alg_worst = [max(r[e] for r in alg) for e in range(TRAIN_EPOCHS)]
    # the sequential CV trained fold 1 then fold 2, TRAIN_EPOCHS resident epochs each
    first = [_first_steps_rel(steps_seq[f * TRAIN_EPOCHS], steps_stk, f) for f in (0, 1)]
    _check_first_steps("[stacked folds]", first)
    _cudnn(True)
    try:
        teacher = _check_teacher("[stacked folds]", seq_caps, stk_caps, at,
                                 TRAIN_EPOCHS * n_train, dev, float64=True)
    finally:
        _cudnn(False)
    del seq_caps[:], stk_caps[:]
    keys = {k: {s: sorted(a[0]) for s, a in r["agg"].items()} for k, r in runs.items()}
    if keys["stk"] != keys["seq"]:
        raise AssertionError(f"[stacked folds] aggregate keys {keys}")
    n = TRAIN_SAMPLES["train"]
    seq_rate = 2 * n / sum(runs["seq"]["epoch_s"])
    stk_rate = 2 * n / runs["stk"]["epoch_s"][0]
    say_card(card, f"[stacked folds] 2 folds sequential {runs['seq']['seconds']:.2f} s, "
             f"stacked {runs['stk']['seconds']:.2f} s through train_multimodal.main; epoch "
             f"{TRAIN_EPOCHS} train samples/s over both folds: sequential {seq_rate:.1f}, "
             f"stacked {stk_rate:.1f}; fused_mlp launches sequential "
             f"{runs['seq']['launches']['fused_mlp']}, stacked "
             f"{runs['stk']['launches']['fused_mlp']} (one per stacked eval step: "
             f"{TRAIN_EPOCHS} × {steps['stk']['validation']} + {steps['stk']['test']})")
    say(f"[stacked folds] first three train steps stacked vs sequential, relative "
        f"difference per fold {first} (tolerances {STACK_RTOL}: step 1, steps 2-3; cuDNN "
        f"deterministic); per-fold epoch losses, largest relative difference per epoch: "
        f"stacked vs sequential {worst}, the sequential CV again with NHWC convolutions vs "
        f"NCHW {alg_worst}; aggregate keys equal")
    return {"runs": runs, "loss_rel": worst, "first_steps_rel": first, "teacher": teacher,
            "algorithm_rel": alg_worst,
            "samples_per_s": {"seq": seq_rate, "stk": stk_rate}}


def phase_stacked_runs(dev, card: str, work: Path) -> dict:
    """Phase 15 (c): UttFusion at the published widths (644/229/686, half
    CMU-MOSI's train split for room, T = 50, batch 32, 2 epochs, dropout 0,
    `--skip-test`: phase 6 tests this model) with `--stacked-runs 3` and `5`
    (6 and 10 lstm groups per launch) against its members run one after
    another at seed + i, cuDNN deterministic: each member's first three
    train steps within 1e-4 / 1e-3; the padded tail (step 21, 4 real rows)
    and epoch 2's first step teacher-forced (each member set to its
    sequential run's state before the step) within TEACHER_RTOL; the epoch
    losses beside them, and beside those member 1 run again with PyTorch's
    own convolutions (`_native_convolutions`; TextCNN's single input
    channel leaves NHWC the same layout); `lstm` exactly once per stacked
    train and eval step,
    and once per train batch and fused eval step of each sequential run."""
    from mmtpu_torch.cli import train_multimodal

    out_root = work / "stacked_runs"
    samples = UTT_HALF_SAMPLES
    cfg = utt_train_config(str(out_root), dropout=False, samples=samples)
    seed = int(cfg["experiment"]["seed"])
    train = -(-samples["train"] // UTT_BATCH)
    at = (train - 1, train)  # the padded tail, epoch 2's first train step
    stk_steps = _eval_batches(samples, UTT_BATCH, UTT_PATTERNS, fused=False)
    want_stk = TRAIN_EPOCHS * (train + stk_steps["validation"])
    want_seq = TRAIN_EPOCHS * (train + utt_expected_launches(samples)["validation"])

    seq, steps_seq, seq_caps = [], [], []
    name = f"{UTT_NAME}_Sequential"
    cfg["experiment"]["name"] = cfg["model"]["name"] = name
    path = work / "runs_seq.json"
    path.write_text(json.dumps(cfg))
    # members 1..5 at seed + i, then member 1 again with native convolutions
    for i, run_id in [(i, i + 1) for i in range(max(STACKED_RUNS))] + [(0, 9)]:
        alg = run_id == 9
        reset_counts()
        _cudnn(True)
        try:
            with contextlib.ExitStack() as hooks:
                hooks.enter_context(_native_convolutions(alg))
                if not alg:
                    hooks.enter_context(_train_step_losses(steps_seq, []))
                    hooks.enter_context(_teacher_capture(at, seq_caps, []))
                rc = train_multimodal.main(["--config", str(path), "--run_id", str(run_id),
                                            "--seed", str(seed + i), "--skip-test"])
        finally:
            _cudnn(False)
        if rc != 0:
            raise AssertionError(f"[stacked runs] sequential run {run_id}: non-zero exit")
        counts = read_counts()
        if counts != {"fused_mlp": 0, "lstm": want_seq}:
            raise AssertionError(f"[stacked runs] sequential run {run_id}: launches {counts}, "
                                 f"expected lstm {want_seq}")
        metrics = out_root / name / "metrics" / str(run_id)
        seq.append({"losses": _epoch_losses(metrics), "epoch_s": json.loads(
            (metrics / "epoch_metrics.json").read_text())[TRAIN_EPOCHS - 1]["train"]["timing"]
            ["total_time"]})
    alg_rel = _loss_rel(seq.pop()["losses"], seq[0]["losses"])
    say(f"[stacked runs] member 1 again with native convolutions vs cuDNN's: epoch losses, "
        f"relative difference per epoch {alg_rel}")
    stacked = {}
    for k in STACKED_RUNS:
        name = f"{UTT_NAME}_Stacked{k}"
        cfg["experiment"]["name"] = cfg["model"]["name"] = name
        path = work / f"runs_stk{k}.json"
        path.write_text(json.dumps(cfg))
        reset_counts()
        steps_stk, stk_caps = [], []
        _cudnn(True)
        t0 = time.perf_counter()
        try:
            with _train_step_losses([], steps_stk), _teacher_capture(at, [], stk_caps):
                rc = train_multimodal.main(["--config", str(path), "--run_id", "1",
                                            "--stacked-runs", str(k), "--skip-test"])
        finally:
            _cudnn(False)
        if rc != 0:
            raise AssertionError(f"[stacked runs {k}] non-zero exit")
        seconds = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"fused_mlp": 0, "lstm": want_stk}:
            raise AssertionError(f"[stacked runs {k}] launches {counts}, expected lstm "
                                 f"{want_stk}: one per stacked step of {2 * k} groups")
        metrics = out_root / name / "metrics"
        losses = [_epoch_losses(metrics / str(i + 1)) for i in range(k)]
        rel = [_loss_rel(got, seq[i]["losses"]) for i, got in enumerate(losses)]
        worst = [max(r[e] for r in rel) for e in range(TRAIN_EPOCHS)]
        first = [_first_steps_rel(steps_seq[i * TRAIN_EPOCHS], steps_stk, i) for i in range(k)]
        _check_first_steps(f"[stacked runs {k}]", first)
        _cudnn(True)
        try:
            teacher = _check_teacher(f"[stacked runs {k}]", seq_caps, stk_caps, at,
                                     TRAIN_EPOCHS * train, dev)
        finally:
            _cudnn(False)
        del stk_caps[:]
        epoch_s = json.loads((metrics / "1/epoch_metrics.json").read_text())[
            TRAIN_EPOCHS - 1]["train"]["timing"]["total_time"]
        rates = {"stk": k * samples["train"] / epoch_s,
                 "seq": k * samples["train"] / sum(r["epoch_s"] for r in seq[:k])}
        stacked[k] = {"seconds": seconds, "launches": counts, "loss_rel": worst,
                      "first_steps_rel": first, "teacher": teacher, "samples_per_s": rates}
        say_card(card, f"[stacked runs {k}] {seconds:.2f} s through train_multimodal.main; "
                 f"epoch {TRAIN_EPOCHS} train samples/s over the {k} members: stacked "
                 f"{rates['stk']:.1f}, the {k} sequential runs {rates['seq']:.1f}; lstm launches "
                 f"{counts['lstm']} (one per stacked step, {2 * k} groups each)")
        say(f"[stacked runs {k}] members vs the sequential runs at seed + i: first three "
            f"train steps' relative differences {first} (tolerances {STACK_RTOL}); epoch "
            f"losses, largest relative difference per epoch {worst} (member 1 with "
            f"native convolutions vs cuDNN's: {alg_rel})")
    return {"stacked": stacked, "seq_launches": want_seq, "algorithm_rel": alg_rel}


def say_phase15(card: str, resident: Optional[dict], folds: Optional[dict],
                runs: Optional[dict], seconds: float) -> None:
    if resident:
        say_card(card, "[summary] resident fine-tune: epoch-2 train samples/s resident "
                 f"{resident['runs']['on']['samples_per_s']:.1f}, streaming "
                 f"{resident['runs']['off']['samples_per_s']:.1f}; busy share resident "
                 f"{resident['busy']['on']:.3f}, streaming {resident['busy']['off']:.3f}; "
                 f"fused_mlp {resident['launches']['on']['fused_mlp']} vs "
                 f"{resident['launches']['off']['fused_mlp']}")
    def forced(teacher):  # the largest loss and update/moment differences of its steps
        out = []
        for kind in ("float32", "float64"):
            rows = [r for step in teacher.values() for r in step.get(kind, [])]
            if rows:
                out.append(f"{kind} loss {max(r['loss'] for r in rows):.3e}, update "
                           f"{max(r['update'] for r in rows):.3e}, first moment "
                           f"{max(r['moment'] for r in rows):.3e}")
        return "teacher-forced steps: " + "; ".join(out)

    if folds:
        say_card(card, f"[summary] stacked folds: samples/s stacked "
                 f"{folds['samples_per_s']['stk']:.1f}, sequential "
                 f"{folds['samples_per_s']['seq']:.1f}; {forced(folds['teacher'])}; epoch "
                 f"losses stacked vs sequential {folds['loss_rel']}, sequential with NHWC "
                 f"vs NCHW convolutions {folds['algorithm_rel']}")
    if runs:
        for k, r in runs["stacked"].items():
            say_card(card, f"[summary] stacked runs {k}: samples/s stacked "
                     f"{r['samples_per_s']['stk']:.1f}, sequential "
                     f"{r['samples_per_s']['seq']:.1f}; lstm {r['launches']['lstm']}; "
                     f"{forced(r['teacher'])}; epoch losses stacked vs sequential "
                     f"{r['loss_rel']}, member 1 with native vs cuDNN convolutions "
                     f"{runs['algorithm_rel']}")
    say(f"[summary] phase 15 {seconds:.1f} s")


def phase15(dev, card: str, work: Path, resident: bool = True, stacked: bool = True) -> dict:
    return {"resident": phase_resident(dev, card, work) if resident else None,
            "folds": phase_stacked_folds(dev, card, work) if stacked else None,
            "runs": phase_stacked_runs(dev, card, work) if stacked else None}


# Phase 16: data parallelism, on one card. The fine-tunes of phases 5 and 6
# through `main` as two ranks on cuda:0 (gloo between them) against one
# process, from the same seed; one rank over NCCL; the CLI's rules.
MESH_RANKS = 2
MESH_DEVICE = "cuda:0"  # every rank's, and the single process's
MESH_NCCL = "nccl"  # (c)'s backend
MESH_TIMEOUT_S = 600  # the ranks' process group and every collective
MESH_VAL_RTOL = 1e-3  # epoch-2 validation loss, two ranks vs one process, float64
MESH_NCCL_RTOL = 1e-5  # one NCCL rank vs one process: the same arithmetic
MESH_REAL_ROWS = 28  # the AVMNIST check's padded batch: its real rows, all on rank 0
# (a)'s float64 runs (the epoch-level check): the fine-tune at full width on
# fewer samples, 2 train steps an epoch, 1 fused eval step a pass
MESH_F64_SAMPLES = {"train": 256, "validation": 64, "test": 64}
# (a)'s float32 run: the three train steps an epoch that its check reads, one
# fused eval step a pass, so that (e)-(g) fit the script's time
MESH_F32_SAMPLES = {"train": 384, "validation": 128, "test": 128}


@contextlib.contextmanager
def _mesh_probe(rec: dict, out_root: Path, mesh, steps_per_epoch: Optional[int] = None):
    """Inside the `with` body: per device-resident train epoch its steps'
    losses (a rank's shares of the global ones), per epoch the model's
    state_dict sha256, per step the gradient all-reduce's bytes and time
    (the card synchronised before and after), and every file under
    `out_root` this process opens for writing or `torch.save`s. For the
    drivers with their own steps (C-MAM, MMIN, RedCore, Self-MM), per train
    step its loss (a rank's share) and, every `steps_per_epoch` steps, the
    model's sha256; RedCore's schedule after each step; the sha256 of
    Self-MM's banks after each update; the (G, B, T, H) of every `lstm`
    launch."""
    import builtins
    import io

    import torch

    from mmtpu_torch.ops import lstm as lstm_ops
    from mmtpu_torch.train import cmam_step, mmin_step, redcore_step, self_mm_step
    from mmtpu_torch.train import device_loop as dl
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.managers import ManagerState

    rec.update(losses=[], hashes=[], reduce=[], writes=[], step_losses=[], epoch_hashes=[],
               sched=[], bank_hashes=[], lstm_shapes=set())
    real = (dl.run_train_epoch, TrainLoop._save_resume_point, builtins.open, io.open,
            torch.save)
    step_modules = (cmam_step, mmin_step, redcore_step, self_mm_step)
    real_custom = ([m.apply_gradients for m in step_modules], lstm_ops._launch,
                   redcore_step.advance_schedule, ManagerState.update_centers)

    def custom_apply(fn):
        def apply(state, loss):
            rec["step_losses"].append(float(loss))
            fn(state, loss)
            if steps_per_epoch and len(rec["step_losses"]) % steps_per_epoch == 0:
                rec["epoch_hashes"].append(_state_hash(state.model.state_dict()))
        return apply

    def launch(xws, whs, *args):
        rec["lstm_shapes"].add((len(xws), *xws[0].shape[:2], whs[0].shape[0]))
        return real_custom[1](xws, whs, *args)

    def advance(task, sched, mses):
        new = real_custom[2](task, sched, mses)
        rec["sched"].append({k: getattr(new, k).detach().cpu().clone()
                             for k in ("beta", "loss_ema", "eta")})
        return new

    def centers(banks, *args, **kwargs):
        out = real_custom[3](banks, *args, **kwargs)
        rec["bank_hashes"].append(_state_hash(_bank_tensors(banks)))
        return out

    def epoch(*args, **kwargs):
        outs = real[0](*args, **kwargs)
        rec["losses"].append([float(v) for v in outs["loss"]])
        return outs

    def resume_point(self, epoch_no, best):
        rec["hashes"].append(_state_hash(self.state.model.state_dict()))
        return real[1](self, epoch_no, best)

    def written(path):
        if isinstance(path, (str, Path)) and str(path).startswith(str(out_root)):
            rec["writes"].append(str(path))

    def opener(fn):
        def opened(file, mode="r", *args, **kwargs):
            if any(c in str(mode) for c in "wax+"):
                written(file)
            return fn(file, mode, *args, **kwargs)
        return opened

    def save(obj, f, *args, **kwargs):
        written(f)
        return real[4](obj, f, *args, **kwargs)

    if mesh is not None:
        reduce_grads = mesh.all_reduce_grads

        def timed(params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = reduce_grads(params)
            torch.cuda.synchronize()
            rec["reduce"].append((nbytes, time.perf_counter() - t0))
            return nbytes

        mesh.all_reduce_grads = timed
    dl.run_train_epoch, TrainLoop._save_resume_point = epoch, resume_point
    builtins.open, io.open, torch.save = opener(real[2]), opener(real[3]), save
    for module, fn in zip(step_modules, real_custom[0]):
        module.apply_gradients = custom_apply(fn)
    lstm_ops._launch, redcore_step.advance_schedule = launch, advance
    ManagerState.update_centers = centers
    try:
        yield
    finally:
        dl.run_train_epoch, TrainLoop._save_resume_point = real[0], real[1]
        builtins.open, io.open, torch.save = real[2], real[3], real[4]
        for module, fn in zip(step_modules, real_custom[0]):
            module.apply_gradients = fn
        lstm_ops._launch, redcore_step.advance_schedule = real_custom[1], real_custom[2]
        ManagerState.update_centers = real_custom[3]
        if mesh is not None:
            mesh.all_reduce_grads = reduce_grads


@contextlib.contextmanager
def _float64_run():
    """Inside the `with` body a training entry point runs in float64: the
    model after its seeded init, every dataset's float32 arrays and the
    criteria; the AVMNIST head on its plain chain (the kernel takes float32
    only)."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.models import avmnist
    from mmtpu_torch.ops import fused_mlp_reference

    real = common.init_model, common.build_all_loaders, avmnist.fused_mlp

    def init(*args, **kwargs):
        return real[0](*args, **kwargs).double()

    def loaders(*args, **kwargs):
        out = real[1](*args, **kwargs)
        for loader in out.values():
            arrays = loader.dataset.arrays
            for m, a in arrays.items():
                if a.dtype == np.float32:
                    arrays[m] = a.astype(np.float64)
        return out

    common.init_model, common.build_all_loaders, avmnist.fused_mlp = (
        init, loaders, fused_mlp_reference)
    try:
        with _float64_losses():
            yield
    finally:
        common.init_model, common.build_all_loaders, avmnist.fused_mlp = real


def _mesh_steps(dev, mesh, cfg: str, float64: bool, pad_rows: Optional[int]) -> dict:
    """From the initial weights (`_training_setup`, replicated from rank 0
    on a mesh), one train step on the first train batch and one on a
    padded batch (the split's last batch, or the third batch with its last
    `pad_rows` rows zeroed); per step the global loss and every parameter's
    gradient as the optimizer sees it (summed over the ranks)."""
    from mmtpu_torch.parallel.mesh import replicate

    config, batches = _train_batches(Path(cfg), 3)
    if pad_rows is None:
        padded = list(config.data.build_loader("train", seed=config.experiment.seed))[-1]
    else:
        padded = {k: v.copy() for k, v in batches[2].items()}
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            padded[k][-pad_rows:] = 0
    out = {}
    for tag, batch in (("step 1", batches[0]), ("padded", padded)):
        model, state, step = _training_setup(config, dev)
        if float64:
            model.double()
            batch = _as_float64(batch)
        if mesh is not None:
            replicate(model, mesh)
            state.mesh = mesh
        with _float64_losses() if float64 else contextlib.nullcontext():
            loss = float(step(batch)["loss"])
        if mesh is not None:
            loss = float(sum(mesh.gather(loss)))
        out[tag] = {"loss": loss, "real_rows": int(batch["sample_mask"].sum()),
                    "grads": {n: p.grad.detach().cpu().clone()
                              for n, p in model.named_parameters()}}
    return out


def _mesh_job(job: dict) -> int:
    """Phase 16's work in one process: in a rank of a launched mesh (the
    ranks run it through `mmtpu_torch.parallel.launch`), or in the parent
    as the single-process run. `job["runs"]`: a CLI's `main` (`module`,
    `train_multimodal` by default) with its argv, each run under
    `_mesh_probe` (and `_float64_run` where asked) with the kernels'
    launches counted; `job["steps"]`: `_mesh_steps`' arguments, or
    `job["driver_steps"]`: `_mesh_driver_steps`'; `job["neutral"]`: all of
    it under `_msa_neutralised`. What it saw goes to
    `<out>/<rank or single>.pt`."""
    import importlib

    import torch

    from mmtpu_torch.parallel.mesh import get_default_mesh

    mesh = get_default_mesh()
    dev = mesh.device if mesh is not None else torch.device(MESH_DEVICE)
    _cudnn(True)
    rec = {"backend": mesh.backend if mesh is not None else None, "runs": []}
    for run in job.get("runs", ()):
        seen = {}
        module = importlib.import_module(run.get("module", "mmtpu_torch.cli.train_multimodal"))
        reset_counts()
        t0 = time.perf_counter()
        with _mesh_probe(seen, Path(job["out_root"]), mesh, run.get("steps_per_epoch")), \
                _float64_run() if run["float64"] else contextlib.nullcontext(), \
                _msa_neutralised() if job.get("neutral") else contextlib.nullcontext():
            rc = module.main(list(run["argv"]))
        if rc != 0:
            return rc
        seen["seconds"], seen["launches"] = time.perf_counter() - t0, read_counts()
        rec["runs"].append(seen)
    if job.get("steps"):
        rec["steps"] = _mesh_steps(dev, mesh, **job["steps"])
    if job.get("driver_steps"):
        with _msa_neutralised() if job.get("neutral") else contextlib.nullcontext():
            rec["steps"] = _mesh_driver_steps(dev, mesh, **job["driver_steps"])
    torch.save(rec, Path(job["out"]) / (f"rank{mesh.rank}.pt" if mesh else "single.pt"))
    return 0


def _mesh_jobs_in_turn(jobs: list) -> int:
    """Every job of `jobs` in this rank, one after another (one process
    start-up for all)."""
    for job in jobs:
        rc = _mesh_job(job)
        if rc != 0:
            return rc
    return 0


def _mesh_run(tag: str, jobs: list, devices, backend: str) -> list:
    """`jobs` in one rank per device of `devices` over `backend`; per job
    what each rank saw."""
    import torch

    from mmtpu_torch.parallel import MeshConfig, create_mesh
    from mmtpu_torch.parallel.launch import launch

    mesh = create_mesh(MeshConfig(len(devices)), devices=devices, backend=backend)
    t0 = time.perf_counter()
    rc = launch(mesh, _mesh_jobs_in_turn, (jobs,), timeout=MESH_TIMEOUT_S)
    if rc != 0:
        raise AssertionError(f"{tag}: a rank exited with code {rc}")
    say(f"{tag} {len(devices)} ranks over {backend} on {[str(d) for d in devices]}: "
        f"{time.perf_counter() - t0:.1f} s, process start-up included")
    return [[torch.load(Path(job["out"]) / f"rank{r}.pt", weights_only=False)
             for r in range(len(devices))] for job in jobs]


def _mesh_single(job: dict) -> dict:
    import torch

    if _mesh_job(job) != 0:
        raise AssertionError(f"{job['runs']}: non-zero exit code")
    return torch.load(Path(job["out"]) / "single.pt", weights_only=False)


def _mesh_jobs(work: Path, tag: str, runs: list, steps: dict) -> tuple:
    """The single process's job and the ranks': each (name, config dict,
    float64) of `runs` through `train_multimodal.main` as run ids 1 (one
    process) and 2 (the ranks), and the steps' check from the first
    config."""
    out_root = work / tag
    paths = []
    for name, cfg, _ in runs:
        cfg["experiment"]["name"] = cfg["model"]["name"] = name
        paths.append(work / f"{name}.json")
        paths[-1].write_text(json.dumps(cfg))
    jobs = []
    for run_id in ("1", "2"):
        out = work / f"{tag}_{run_id}"
        out.mkdir(parents=True)
        jobs.append({"runs": [{"argv": ["--config", str(p), "--run_id", run_id],
                               "float64": f64} for p, (_, _, f64) in zip(paths, runs)],
                     "out_root": str(out_root), "out": str(out),
                     "steps": {**steps, "cfg": str(paths[0])}})
    return out_root, jobs


def _summed_losses(ranks: list, i: int) -> list:
    """Per epoch of run `i` the global train-step losses: the ranks' shares
    summed."""
    return [[sum(v) for v in zip(*epoch)]
            for epoch in zip(*(r["runs"][i]["losses"] for r in ranks))]


def _mesh_epochs(out_root: Path, name: str, run_id: str) -> list:
    return [(e["train"]["loss"], e["validation"]["loss"], e["train"]["timing"]["total_time"])
            for e in json.loads((out_root / name / "metrics" / run_id
                                 / "epoch_metrics.json").read_text()) if "epoch" in e]


def _mesh_compare(tag: str, card: str, out_root: Path, names: list, single: dict, ranks: list,
                  want: dict, train_samples: int, loss_rtol: tuple, grad_tol: float,
                  pad_rtol: float) -> dict:
    """Two ranks against one process: run 0's first three train steps, its
    launches per rank, the ranks' states after every epoch of every run,
    every file written by rank 0 alone; the steps' losses and gradients;
    each run's epoch losses (judged in a float64 run, printed otherwise);
    the gradient all-reduce and samples/s of run 0."""
    import torch

    seq, got = single["runs"][0]["losses"][0], _summed_losses(ranks, 0)[0]
    rel = [abs(got[t] - seq[t]) / abs(seq[t]) for t in range(3)]
    for i in range(len(names)):
        hashes = [r["runs"][i]["hashes"] for r in ranks]
        if len(hashes[0]) != TRAIN_EPOCHS or any(h != hashes[0] for h in hashes):
            raise AssertionError(f"{tag} {names[i]}: the ranks' states differ after an epoch: "
                                 f"{hashes}")
        if ranks[1]["runs"][i]["writes"] or not ranks[0]["runs"][i]["writes"]:
            raise AssertionError(f"{tag} {names[i]}: rank 1 wrote "
                                 f"{ranks[1]['runs'][i]['writes'][:5]}")
    launches = [r["runs"][0]["launches"] for r in ranks] + [single["runs"][0]["launches"]]
    if any(n != want for n in launches):
        raise AssertionError(f"{tag}: launches per rank, then one process, {launches}; "
                             f"expected {want}")
    steps = {}
    for key in ("step 1", "padded"):
        one, two = single["steps"][key], ranks[0]["steps"][key]
        if any(not torch.equal(r["steps"][key]["grads"][n], g)
               for r in ranks[1:] for n, g in two["grads"].items()):
            raise AssertionError(f"{tag} {key}: the ranks' summed gradients differ")
        err = _grad_errors(two["grads"], one["grads"])
        steps[key] = {"loss_rel": abs(two["loss"] - one["loss"]) / abs(one["loss"]),
                      "grad_err": max(err.values()), "worst": _worst(err),
                      "real_rows": one["real_rows"]}
    epochs = {}
    for name, f64 in names:
        one, two = (_mesh_epochs(out_root, name, r) for r in "12")
        val_rel = [abs(b[1] - a[1]) / abs(a[1]) for a, b in zip(one, two)]
        epochs[name] = {"val_rel": val_rel, "float64": f64, "one": one, "two": two}
        say(f"{tag} {name} ({'float64' if f64 else 'float32'}): epoch (train loss, validation "
            f"loss) one process {[e[:2] for e in one]}, two ranks {[e[:2] for e in two]}; "
            f"validation relative {val_rel}" + (
                f" (tolerance {MESH_VAL_RTOL} at epoch {TRAIN_EPOCHS})" if f64 else
                " (float32: printed; a sequential ResNet run moved 3.7e-2 at epoch 2 under "
                "channels_last alone)"))
    reduce = ranks[0]["runs"][0]["reduce"]
    nbytes = sorted({n for n, _ in reduce})
    reduce_ms = [s * 1e3 for _, s in reduce]
    first = epochs[names[0][0]]
    sps = {k: train_samples / first[k][-1][2] for k in ("one", "two")}
    say(f"{tag} train losses of steps 1-3, one process {seq[:3]}, two ranks {got[:3]}: "
        f"relative {rel} (tolerances {loss_rtol})")
    for key, s in steps.items():
        say(f"{tag} {key} ({s['real_rows']} real rows) from the initial weights: loss relative "
            f"{s['loss_rel']:.3e} (tolerance {pad_rtol}), gradients worst parameter "
            f"{s['grad_err']:.3e} of its norm (tolerance {grad_tol}), worst {s['worst']}")
    say(f"{tag} the ranks' state_dict sha256 after each epoch "
        f"{[r['hashes'] for r in ranks[0]['runs']]}, equal on every rank; launches per rank "
        f"{launches[:-1]}, one process {launches[-1]}; files written by rank 0 "
        f"{[len(r['writes']) for r in ranks[0]['runs']]}, by rank 1 0")
    say_card(card, f"{tag} gradient all-reduce per step (gloo, two ranks on one card): "
             f"{nbytes} bytes, {statistics.median(reduce_ms):.3f} ms median over "
             f"{len(reduce_ms)} steps (min {min(reduce_ms):.3f}, max {max(reduce_ms):.3f})")
    say_card(card, f"{tag} epoch {TRAIN_EPOCHS} train samples/s: one process {sps['one']:.1f}, "
             f"two processes sharing one card {sps['two']:.1f} (not a scaling number); "
             f"main's wall time one process {single['runs'][0]['seconds']:.1f} s, two ranks "
             f"{ranks[0]['runs'][0]['seconds']:.1f} s")
    if rel[0] > loss_rtol[0] or max(rel[1:]) > loss_rtol[1]:
        raise AssertionError(f"{tag}: train losses differ from one process: {rel}")
    for key, s in steps.items():
        if s["grad_err"] > grad_tol or s["loss_rel"] > pad_rtol:
            raise AssertionError(f"{tag} {key}: loss {s['loss_rel']}, gradients "
                                 f"{s['grad_err']} ({s['worst']})")
    for name, e in epochs.items():
        if e["float64"] and e["val_rel"][-1] > MESH_VAL_RTOL:
            raise AssertionError(f"{tag} {name}: epoch-{TRAIN_EPOCHS} validation loss differs "
                                 f"by {e['val_rel']}")
    return {"loss_rel": rel, "epochs": epochs, "steps": steps, "reduce_bytes": nbytes,
            "reduce_ms": statistics.median(reduce_ms), "samples_per_s": sps,
            "launches": launches[0], "seconds": ranks[0]["runs"][0]["seconds"]}


def _mesh_avmnist_jobs(work: Path) -> tuple:
    """Phase 16 (a)'s jobs: phase 15's scratch fine-tune (dropout 0) on
    384/128/128 samples and the same in float64 on 256/64/64; the steps in
    float64 with a padded batch of 28 real rows, none on rank 1."""
    import copy

    cfg = train_configs(str(work / "mesh_avmnist"))["scratch"]
    cfg["model"]["dropout"] = 0.0
    cfg64 = copy.deepcopy(cfg)
    _resize(cfg, MESH_F32_SAMPLES)
    _resize(cfg64, MESH_F64_SAMPLES)
    names = [(f"{SCRATCH_NAME}_Mesh", False), (f"{SCRATCH_NAME}_Mesh_Float64", True)]
    return names, _mesh_jobs(
        work, "mesh_avmnist", [(names[0][0], cfg, False), (names[1][0], cfg64, True)],
        {"float64": True, "pad_rows": TRAIN_BATCH - MESH_REAL_ROWS})


def phase_mesh_avmnist(card: str, prepared: tuple, single: dict, ranks: list) -> dict:
    """Phase 16 (a), the fine-tune in one process against two ranks on
    cuda:0 over gloo: step 1's loss within 1e-4, steps 2-3 within 1e-3, step
    1's and the padded step's float64 gradients within 1e-6 of each
    parameter's norm, the ranks' states equal after each epoch, `fused_mlp`
    3 per rank, rank 0 alone writing; the float64 run's epoch-2 validation
    loss within 1e-3 (in float32 the runs' own rounding, amplified by Adam
    near g = 0, moves it by more: printed)."""
    names, (out_root, _) = prepared
    fused = _eval_batches(MESH_F32_SAMPLES, TRAIN_BATCH)
    want = {"fused_mlp": TRAIN_EPOCHS * fused["validation"] + fused["test"], "lstm": 0}
    return _mesh_compare("[mesh avmnist]", card, out_root, names, single, ranks, want,
                         MESH_F32_SAMPLES["train"], (TRAIN_LOSS_RTOL, TRAIN_LATER_RTOL),
                         TRAIN_GRAD64_TOL, TRAIN_LOSS_RTOL)


def _mesh_utt_jobs(work: Path) -> tuple:
    """Phase 16 (b)'s jobs: phase 6's UttFusion, dropout 0, float32, on
    half the train split, for room."""
    cfg = utt_train_config(str(work / "mesh_utt"), dropout=False, samples=UTT_HALF_SAMPLES)
    names = [(f"{UTT_NAME}_Mesh", False)]
    return names, _mesh_jobs(work, "mesh_utt", [(names[0][0], cfg, False)],
                             {"float64": False, "pad_rows": None})


def _mesh_nccl(work: Path, steps: dict):
    """Phase 16 (c), started on a thread beside (d), after every timed run:
    (b)'s steps as one rank over NCCL. Returns a function that waits for it
    and gives what the rank saw (or raises what the launch raised)."""
    import threading

    import torch

    job = {"out": str(work / "mesh_nccl"), "steps": steps}
    Path(job["out"]).mkdir()
    done = {}

    def run():
        try:
            done["rank"] = _mesh_run("[mesh nccl]", [job], [torch.device(MESH_DEVICE)],
                                     MESH_NCCL)[0][0]
        except BaseException as e:  # noqa: BLE001 — re-raised by the waiter
            done["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait() -> dict:
        thread.join(MESH_TIMEOUT_S)
        if thread.is_alive():
            raise AssertionError("[mesh nccl] the rank did not end within the timeout")
        if "error" in done:
            raise done["error"]
        return done["rank"]

    return wait


def phase_mesh_utt(card: str, prepared: tuple, single: dict, ranks: list,
                   nccl: dict) -> dict:
    """Phase 16 (b): phase 6's UttFusion at the published widths (dropout
    0, float32, the kernel's only type) in one process against two ranks on
    cuda:0 over gloo: step 1 and the padded tail (4 real rows of 32, none
    on rank 1) within 1e-5, steps 2-3 within 1e-3, step 1's gradients within
    1e-4 of each norm, the states equal after each epoch, `lstm` 75 per
    rank (644 train samples); then (c)'s one NCCL rank against the same
    steps, within 1e-5."""
    names, (out_root, _) = prepared
    want = {"fused_mlp": 0, "lstm": utt_expected_launches(UTT_HALF_SAMPLES)["total"]}
    if ranks[0]["steps"]["padded"]["real_rows"] > UTT_BATCH // MESH_RANKS:
        raise AssertionError("[mesh utt] the padded tail has real rows on rank 1")
    res = _mesh_compare("[mesh utt]", card, out_root, names, single, ranks, want,
                        UTT_HALF_SAMPLES["train"], (UTT_LOSS_RTOL, TRAIN_LATER_RTOL),
                        UTT_GRAD_TOL, UTT_LOSS_RTOL)
    nccl_rel = {k: abs(nccl["steps"][k]["loss"] - single["steps"][k]["loss"])
                / abs(single["steps"][k]["loss"]) for k in single["steps"]}
    say(f"[mesh nccl] backend {nccl['backend']}, one rank: losses of step 1 and the padded "
        f"tail relative to one process {nccl_rel} (tolerance {MESH_NCCL_RTOL})")
    if nccl["backend"] != MESH_NCCL or max(nccl_rel.values()) > MESH_NCCL_RTOL:
        raise AssertionError(f"[mesh nccl] {nccl['backend']}: {nccl_rel}")
    return {**res, "nccl_rel": nccl_rel}


def phase_mesh_cli(dev, work: Path) -> None:
    """Phase 16 (d): on one card `--data-parallel 2` raises mmtpu's
    ValueError before a rank starts; `--data-parallel -1` trains on the one
    device, in this process."""
    from mmtpu_torch.cli import train_multimodal
    from mmtpu_torch.parallel import launch as launch_mod

    cfg = utt_train_config(str(work / "mesh_cli"), dropout=False)
    for split in cfg["data"]["datasets"].values():  # the rule, not the training: small splits
        split["kwargs"]["num_samples"] = 2 * UTT_BATCH
    path = work / "mesh_cli.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--run_id", "1", "--epochs", "1", "--skip-test"]
    try:
        train_multimodal.main([*argv, "--data-parallel", "2"])
    except ValueError as e:
        if "data_parallel=2 but only 1 devices visible" not in str(e):
            raise
        say(f"[mesh cli] --data-parallel 2 on one card: ValueError: {e}")
    else:
        raise AssertionError("[mesh cli] --data-parallel 2 on one card did not raise")
    real, started = launch_mod.run_cli, []
    launch_mod.run_cli = lambda *a, **k: started.append(a) or 1
    try:
        rc = train_multimodal.main([*argv, "--data-parallel", "-1"])
    finally:
        launch_mod.run_cli = real
    if rc != 0 or started:
        raise AssertionError(f"[mesh cli] --data-parallel -1: exit code {rc}, ranks {started}")
    say("[mesh cli] --data-parallel -1 on one card trained in this process (no rank started)")


# Phase 16 (e)-(g): the drivers with their own steps on the mesh, at the widths
# of phases 9-11 on small splits: DualCMAM A→(V, T) with every pair term on,
# the AVMNIST C-MAM's steps in float64, MMIN with its frozen teacher, RedCore,
# and Self-MM over a frozen BERT-base for two epochs.
MESH_DRIVER_SAMPLES = {"train": 100, "validation": 32, "test": 32}  # a tail of 4 real rows
MESH_SELF_MM_SAMPLES = {"train": 68, "validation": 32, "test": 32}  # 3 train steps an epoch
MESH_CMAM64_SAMPLES = {"train": 384, "validation": 128, "test": 128}  # 3 steps of 128
MESH_CMAM64_REAL_ROWS = 28  # its padded step: 28 real rows of 128, all on rank 0
MESH_PAIR_TERMS = {"mmd_weight": 0.1, "moment_weight": 0.1, "mi_weight": 0.1}
MESH_DRIVER_TOL = {"loss": (1e-5, 1e-3), "grad": 1e-4, "pad": 1e-5}
MESH_CMAM64_TOL = 1e-6  # float64 losses of steps 1-3 and step-1 gradients
MESH_SCHED_TOL = 1e-6  # RedCore's β, EMA and η after three float64 steps
MESH_BANK_TOL = 1e-5  # Self-MM's banks after an epoch-2 step


def _mesh_bases(work: Path) -> dict:
    """Seeded teachers: the AVMNIST fine-tune's and UttFusion's (DualCMAM's
    base and MMIN's teacher), as `best.pth` under run ids 1 and 2 (the
    configs name them by `{run_id}`)."""
    bases = cmam_bases(work / "mesh_bases")
    for path in bases.values():
        twin = path.parent.parent / "2" / path.name
        twin.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, twin)
    return bases


def _resize(cfg: dict, samples: dict) -> dict:
    for split, n in samples.items():
        cfg["data"]["datasets"][split]["kwargs"]["num_samples"] = n
    return cfg


def _mesh_driver_configs(work: Path) -> dict:
    """kind → (config, CLI module, samples): phase 9's DualCMAM (dropout 0,
    the pair terms on), phase 10's MMIN and RedCore (dropout 0), phase 11's
    frozen Self-MM (dropout 0) and phase 9's AVMNIST C-MAM (dropout 0, its
    steps only), each on small splits."""
    out_root = str(work / "mesh_drivers")
    bases = _mesh_bases(work)
    csvs = write_avmnist_files(work / "mesh_avmnist_data", MESH_CMAM64_SAMPLES)["csvs"]
    cmam = cmam_configs(out_root, csvs, bases, dropout=False)
    dual = cmam["dual"]
    dual["training"]["loss_functions"]["cmam"]["loss_kwargs"].update(MESH_PAIR_TERMS)
    msa = msa_configs(out_root, bases["dual"], check=True)
    cmam_module, multi = "mmtpu_torch.cli.train_cmam", "mmtpu_torch.cli.train_multimodal"
    return {
        "dual": (_resize(dual, MESH_DRIVER_SAMPLES), cmam_module, MESH_DRIVER_SAMPLES),
        "mmin": (_resize(msa["mmin"], MESH_DRIVER_SAMPLES), multi, MESH_DRIVER_SAMPLES),
        "redcore": (_resize(msa["redcore"], MESH_DRIVER_SAMPLES), multi, MESH_DRIVER_SAMPLES),
        "self_mm": (_resize(self_mm_config(out_root, "frozen", check=True),
                            MESH_SELF_MM_SAMPLES), multi, MESH_SELF_MM_SAMPLES),
        "cmam64": (cmam["cmam"], cmam_module, MESH_CMAM64_SAMPLES),
    }


def _driver_setup(kind: str, cfg_path: Path, dev, mesh):
    """The config and what the driver's CLI assembles from it on `dev` (the
    model replicated from rank 0 on a mesh): model, state, task, the train
    step's builder and the models to cast for a float64 run."""
    from mmtpu_torch.cli import common, msa_runners, train_cmam, train_self_mm
    from mmtpu_torch.config.cmam import CMAMConfig
    from mmtpu_torch.parallel.mesh import replicate
    from mmtpu_torch.train.self_mm_step import make_self_mm_train_step

    args = argparse.Namespace(config=str(cfg_path), run_id=1, seed=None)
    if kind in ("dual", "cmam64"):
        cfg = common.finalize_config(CMAMConfig.load(cfg_path, run_id=1), args, mesh)
        built = train_cmam.assemble(cfg, dev)
        model, state, task, make = built.cmam, built.state, built.task, built.step_builders[0]
        models = (built.base, built.cmam)
    elif kind in ("mmin", "redcore"):
        cfg = common.load_config(args, mesh)
        built = msa_runners.assemble(cfg, args, dev)
        model, state, task, make = built.model, built.state, built.task, built.step_builders[0]
        models = (built.model,)
    else:
        cfg = common.load_config(args, mesh)
        model, task, state = train_self_mm.assemble(cfg, dev)
        make, models = make_self_mm_train_step, (model,)
    if mesh is not None:
        replicate(model, mesh)
        state.mesh = mesh
    return cfg, model, state, task, make, models


def _mesh_driver_steps(dev, mesh, kind: str, cfg: str) -> dict:
    """From the initial weights (rank 0's on a mesh): step 1 on the first
    train batch, then (Self-MM) one epoch-2 step and the banks after it, or
    (RedCore, the AVMNIST C-MAM: in float64) steps 2 and 3; then, from the
    initial weights again, the padded step (the split's tail of 4 real rows
    of 32, or the third batch with 28 real rows of 128: none on rank 1).
    Per step the global loss (the ranks' shares summed); step 1's gradients
    as the optimizer sees them (summed over the ranks), the exact zeros (a
    frozen BERT) by name; RedCore's schedule after three steps."""
    import copy

    import torch

    from mmtpu_torch.cli import train_self_mm
    from mmtpu_torch.train.managers import ManagerState
    from mmtpu_torch.train.self_mm_step import init_manager_labels

    float64 = kind in ("redcore", "cmam64")
    config, model, state, task, make, models = _driver_setup(kind, Path(cfg), dev, mesh)
    if float64:
        for m in models:
            m.double()
    batches = list(config.data.build_loader("train", seed=config.experiment.seed))
    if kind == "cmam64":
        padded = {k: v.copy() for k, v in batches[2].items()}
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            padded[k][MESH_CMAM64_REAL_ROWS:] = 0
    else:
        padded = batches[-1]
    initial = ({k: v.clone() for k, v in model.state_dict().items()},
               copy.deepcopy(state.optimizer.state_dict()))

    def fresh():
        model.load_state_dict(initial[0])
        state.optimizer.load_state_dict(copy.deepcopy(initial[1]))
        state.step = 0
        step = fresh.step = make(task, state, dev)
        if kind != "self_mm":
            return lambda batch, epoch=1: step(batch)
        banks = ManagerState.create(config.data.datasets["train"].kwargs["num_samples"],
                                    train_self_mm.bank_dims(config), device=dev)
        init_manager_labels(banks, config.data.build_loader("train",
                                                            seed=config.experiment.seed))
        fresh.banks = banks
        return lambda batch, epoch=1: step(banks, batch, epoch)

    def run(step, batch, epoch=1):
        with _float64_losses() if float64 else contextlib.nullcontext():
            loss = float(step(_as_float64(batch) if float64 else batch, epoch)["loss"])
        return float(sum(mesh.gather(loss))) if mesh is not None else loss

    out = {"real_rows": int(padded["sample_mask"].sum())}
    step = fresh()
    out["losses"] = [run(step, batches[0])]
    grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    out["zero"] = sorted(n for n, g in grads.items() if not g.any())
    out["grads"] = {n: g for n, g in grads.items() if n not in out["zero"]}
    if kind == "self_mm":
        run(step, batches[1], epoch=2)
        out["banks"] = {k: v.detach().cpu().clone() for k, v in _bank_tensors(fresh.banks).items()}
    elif float64:
        out["losses"] += [run(step, b) for b in batches[1:3]]
        if kind == "redcore":
            out["sched"] = {k: getattr(fresh.step.sched, k).detach().cpu().clone()
                            for k in ("beta", "loss_ema", "eta")}
    out["padded"] = run(fresh(), padded)
    return out


def _mesh_driver_jobs(work: Path) -> dict:
    """kind → (the single process's job, the ranks'): the driver's CLI as
    run ids 1 (one process) and 2 (the ranks), and `_mesh_driver_steps`
    (the AVMNIST C-MAM: its steps alone)."""
    out_root = work / "mesh_drivers"
    jobs = {}
    for kind, (cfg, module, samples) in _mesh_driver_configs(work).items():
        path = work / f"mesh_{kind}.json"
        path.write_text(json.dumps(cfg))
        batch = cfg["data"]["datasets"]["train"]["batch_size"]
        pair = []
        for run_id in ("1", "2"):
            out = work / f"mesh_{kind}_{run_id}"
            out.mkdir(parents=True)
            runs = [] if kind == "cmam64" else [{
                "module": module, "argv": ["--config", str(path), "--run_id", run_id],
                "float64": False, "steps_per_epoch": -(-samples["train"] // batch)}]
            pair.append({"runs": runs, "out_root": str(out_root), "out": str(out),
                         "neutral": kind == "redcore",
                         "driver_steps": {"kind": kind, "cfg": str(path)}})
        jobs[kind] = tuple(pair)
    return jobs


def _mesh_driver_launches(kind: str) -> dict:
    """`lstm` launches of a run in each process (one, or each rank): per
    batch 3 for DualCMAM, 3 per MMIN train batch and 1 per evaluation
    batch, 2 for Self-MM; none for RedCore; `fused_mlp` none."""
    samples = MESH_SELF_MM_SAMPLES if kind == "self_mm" else MESH_DRIVER_SAMPLES
    n = {s: -(-k * (len(MSA_EVAL_PATTERNS) if kind == "mmin" and s != "train" else 1)
              // UTT_BATCH) for s, k in samples.items()}
    per = {"dual": (3, 3), "mmin": (3, 1), "redcore": (0, 0), "self_mm": (2, 2)}[kind]
    return {"fused_mlp": 0, "lstm": TRAIN_EPOCHS * (per[0] * n["train"]
                                                    + per[1] * n["validation"])
            + per[1] * n["test"]}


def _mesh_driver_shapes(kind: str) -> set:
    """The (G, B, T, H) of the `lstm` launches of each rank: UttFusion's
    nets at 64 (MMIN's student pair stacked), Self-MM's AuViSubNets."""
    return {"dual": {(1, 16, 50, 64)}, "mmin": {(2, 16, 50, 64), (1, 16, 50, 64)},
            "redcore": set(), "self_mm": {(1, 16, 50, 16), (1, 16, 50, 32)}}[kind]


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _check_mesh_run(tag: str, card: str, kind: str, single: dict, ranks: list) -> dict:
    """The CLI's run on two ranks against one process: steps 1-3's losses,
    the launches and `lstm` shapes per rank, the ranks' states after each
    epoch, RedCore's schedules and Self-MM's banks equal on the ranks, rank
    1 writing nothing, the gradient all-reduce."""
    one, two = single["runs"][0], [r["runs"][0] for r in ranks]
    got = [sum(v) for v in zip(*(r["step_losses"] for r in two))]
    rel = [_rel(a, b) for a, b in zip(got[:3], one["step_losses"][:3])]
    want, shapes = _mesh_driver_launches(kind), _mesh_driver_shapes(kind)
    launches = [r["launches"] for r in two] + [one["launches"]]
    hashes = [r["epoch_hashes"] for r in two]
    same_sched = all(torch_equal(a, b) for a, b in zip(*(r["sched"] for r in two)))
    same_banks = two[0]["bank_hashes"] == two[1]["bank_hashes"]
    reduce_ms = [t * 1e3 for _, t in two[0]["reduce"]]
    nbytes = sorted({n for n, _ in two[0]["reduce"]})
    say(f"{tag} train losses of steps 1-3, one process {one['step_losses'][:3]}, two ranks "
        f"{got[:3]}: relative {rel} (tolerances {MESH_DRIVER_TOL['loss']}); launches per "
        f"rank {launches[:-1]}, one process {launches[-1]} (expected {want}); lstm shapes "
        f"per rank {sorted(two[0]['lstm_shapes'])}; state sha256 after each epoch "
        f"{[h[:12] for h in hashes[0]]}, equal on both ranks: {hashes[0] == hashes[1]}; "
        f"files written by rank 0 {len(two[0]['writes'])}, by rank 1 {len(two[1]['writes'])}"
        + (f"; schedule after each step equal on both ranks: {same_sched}, after step 3 "
           f"{ {k: v.tolist() for k, v in two[0]['sched'][2].items()} }"
           if kind == "redcore" else "")
        + (f"; banks' sha256 after each of {len(two[0]['bank_hashes'])} updates equal on both "
           f"ranks: {same_banks}" if kind == "self_mm" else ""))
    say_card(card, f"{tag} gradient all-reduce per step (gloo, two ranks on one card): "
             f"{nbytes} bytes, {statistics.median(reduce_ms):.3f} ms median over "
             f"{len(reduce_ms)} steps (min {min(reduce_ms):.3f}, max {max(reduce_ms):.3f}); "
             f"main's wall time one process {one['seconds']:.1f} s (beside the NCCL rank), "
             f"two ranks {two[0]['seconds']:.1f} s")
    if rel[0] > MESH_DRIVER_TOL["loss"][0] or max(rel[1:]) > MESH_DRIVER_TOL["loss"][1]:
        raise AssertionError(f"{tag}: train losses differ from one process: {rel}")
    if any(n != want for n in launches) or any(r["lstm_shapes"] != shapes for r in two):
        raise AssertionError(f"{tag}: launches {launches}, expected {want}; shapes "
                             f"{[sorted(r['lstm_shapes']) for r in two]}, expected {shapes}")
    if len(hashes[0]) != TRAIN_EPOCHS or hashes[0] != hashes[1]:
        raise AssertionError(f"{tag}: the ranks' states differ after an epoch: {hashes}")
    if two[1]["writes"] or not two[0]["writes"]:
        raise AssertionError(f"{tag}: rank 1 wrote {two[1]['writes'][:5]}")
    if not (same_sched and same_banks):
        raise AssertionError(f"{tag}: the ranks' schedules or banks differ")
    return {"loss_rel": rel, "launches": launches[0], "reduce_bytes": nbytes,
            "reduce_ms": statistics.median(reduce_ms), "seconds": two[0]["seconds"],
            "single_seconds": one["seconds"], "shapes": sorted(two[0]["lstm_shapes"])}


def torch_equal(a: dict, b: dict) -> bool:
    import torch

    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _check_mesh_steps(tag: str, kind: str, single: dict, ranks: list) -> dict:
    """`_mesh_driver_steps` on two ranks against one process: step 1's (and
    the float64 runs' steps 2-3) losses, the padded step's, step 1's
    gradients of each parameter against its norm (the ranks' bit-identical,
    the exact zeros the same), RedCore's schedule, Self-MM's banks."""
    one, two = single["steps"], ranks[0]["steps"]
    float64 = kind in ("redcore", "cmam64")
    tol = MESH_CMAM64_TOL if float64 else MESH_DRIVER_TOL["grad"]
    loss_tol = MESH_CMAM64_TOL if float64 else MESH_DRIVER_TOL["loss"][0]
    rel = [_rel(a, b) for a, b in zip(two["losses"], one["losses"])]
    pad_rel = _rel(two["padded"], one["padded"])
    # a gradient that is 0 but for rounding (the attention key biases; a
    # softmax does not see them) is judged against the whole gradient's norm
    norm_all = float(np.sqrt(sum(float(g.double().square().sum())
                                 for g in one["grads"].values())))
    tiny = {n for n, g in one["grads"].items()
            if n.endswith("key.bias") or g.double().norm().item() <= 1e-9 * norm_all}
    err = _grad_errors({n: g for n, g in two["grads"].items() if n not in tiny},
                       {n: g for n, g in one["grads"].items() if n not in tiny})
    err.update({n: (two["grads"][n].double() - one["grads"][n].double()).abs().max().item()
                / norm_all for n in tiny})
    ranks_equal = torch_equal(ranks[1]["steps"]["grads"], two["grads"])
    extra = {}
    if kind == "redcore":
        extra["sched"] = max(_rel_tensor(two["sched"][k], one["sched"][k]) for k in one["sched"])
        ranks_equal &= torch_equal(ranks[1]["steps"]["sched"], two["sched"])
    if kind == "self_mm":
        extra["banks"] = max(
            (t - one["banks"][k]).abs().max().item() / max(1.0, one["banks"][k].abs().max().item())
            for k, t in two["banks"].items())
        ranks_equal &= torch_equal(ranks[1]["steps"]["banks"], two["banks"])
    say(f"{tag} from the same initial weights, {'float64' if float64 else 'float32'}: losses "
        f"of step{'s 1-3' if len(rel) > 1 else ' 1'} one process {one['losses']}, two ranks "
        f"{two['losses']}: relative {rel} (tolerance {loss_tol}); padded step "
        f"({one['real_rows']} real rows, none on rank 1) relative {pad_rel:.3e} (tolerance "
        f"{loss_tol}); step-1 gradients, {len(err)} parameters: worst "
        f"{max(err.values()):.3e} of its norm (of the whole gradient's for {len(tiny)} "
        f"near 0; tolerance {tol}), worst {_worst(err)}; "
        f"{len(one['zero'])} with an exact gradient of 0 on both paths: "
        f"{one['zero'] == two['zero']}"
        + (f"; β, EMA, η after three steps relative {extra['sched']:.3e} (tolerance "
           f"{MESH_SCHED_TOL}) {[(k, v.tolist()) for k, v in two['sched'].items()]}"
           if "sched" in extra else "")
        + (f"; banks after an epoch-2 step worst {extra['banks']:.3e} (tolerance "
           f"{MESH_BANK_TOL})" if "banks" in extra else "")
        + f"; the ranks' bit-identical: {ranks_equal}")
    if max(rel) > loss_tol or pad_rel > loss_tol or max(err.values()) > tol:
        raise AssertionError(f"{tag}: losses {rel}, padded {pad_rel}, gradients "
                             f"{_worst(err)}")
    if not ranks_equal or one["zero"] != two["zero"]:
        raise AssertionError(f"{tag}: the ranks' steps differ, or the exact zeros")
    if extra.get("sched", 0.0) > MESH_SCHED_TOL or extra.get("banks", 0.0) > MESH_BANK_TOL:
        raise AssertionError(f"{tag}: {extra}")
    return {"loss_rel": rel, "pad_rel": pad_rel, "grad_err": max(err.values()), **extra}


def _rel_tensor(got, want) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1e-30)).item()


def phase_mesh_drivers(card: str, jobs: dict, singles: dict, ranks: dict) -> dict:
    """Phase 16 (e)-(g): per driver its CLI's run (`_check_mesh_run`; the
    AVMNIST C-MAM has none) and its steps (`_check_mesh_steps`)."""
    out = {}
    for kind in jobs:
        tag = f"[mesh {kind}]"
        res = {"steps": _check_mesh_steps(tag, kind, singles[kind], ranks[kind])}
        if singles[kind]["runs"]:
            res.update(_check_mesh_run(tag, card, kind, singles[kind], ranks[kind]))
        out[kind] = res
    return out


def say_phase16(card: str, p16: dict, seconds: float) -> None:
    for key, r in (("AVMNIST", p16["avmnist"]), ("UttFusion", p16["utt"])):
        epochs = "; ".join(f"{name} {'float64' if e['float64'] else 'float32'} epoch "
                           f"validation {e['val_rel']}" for name, e in r["epochs"].items())
        say_card(card, f"[summary] mesh {key}: two ranks on one card vs one process, steps 1-3 "
                 f"{r['loss_rel']}; {epochs}; gradient all-reduce {r['reduce_bytes']} bytes "
                 f"in {r['reduce_ms']:.3f} ms per step; samples/s one process "
                 f"{r['samples_per_s']['one']:.1f}, two processes sharing one card "
                 f"{r['samples_per_s']['two']:.1f}; launches per rank {r['launches']}")
    for kind, r in p16["drivers"].items():
        run = (f"; CLI steps 1-3 {r['loss_rel']}, gradient all-reduce {r['reduce_bytes']} "
               f"bytes in {r['reduce_ms']:.3f} ms per step, main's wall time two ranks "
               f"{r['seconds']:.1f} s, one process {r['single_seconds']:.1f} s, launches per "
               f"rank {r['launches']}" if "launches" in r else "")
        say_card(card, f"[summary] mesh {kind}: two ranks on one card vs one process, steps "
                 f"{r['steps']}" + run)
    say(f"[summary] mesh NCCL, one rank: {p16['utt']['nccl_rel']}; phase 16 {seconds:.1f} s")


def phase16(dev, card: str, work: Path) -> dict:
    """(a)'s, (b)'s and (e)-(g)'s two-rank jobs share one launch (one
    start-up), after (a)'s and (b)'s single-process runs, whose samples/s
    are compared with the ranks'; (c)'s NCCL rank starts once those timed
    runs have ended, on a thread beside (d) and (e)-(g)'s single-process
    runs (their wall times are printed, not compared)."""
    import torch

    av, utt, drivers = _mesh_avmnist_jobs(work), _mesh_utt_jobs(work), _mesh_driver_jobs(work)
    (_, (av_one, av_two)), (_, (utt_one, utt_two)) = av[1], utt[1]
    singles = [_mesh_single(av_one), _mesh_single(utt_one)]
    av_ranks, utt_ranks, *driver_ranks = _mesh_run(
        "[mesh avmnist, utt, " + ", ".join(drivers) + "]",
        [av_two, utt_two, *(two for _, two in drivers.values())],
        [torch.device(MESH_DEVICE)] * MESH_RANKS, "gloo")
    nccl_wait = _mesh_nccl(work, utt_two["steps"])
    try:
        cli = phase_mesh_cli(dev, work)
        t0 = time.perf_counter()
        driver_singles = {kind: _mesh_single(one) for kind, (one, _) in drivers.items()}
        say(f"[mesh {', '.join(drivers)}] one process: {time.perf_counter() - t0:.1f} s, "
            "beside the NCCL rank")
    finally:
        nccl = nccl_wait()
    return {"avmnist": phase_mesh_avmnist(card, av, singles[0], av_ranks),
            "utt": phase_mesh_utt(card, utt, singles[1], utt_ranks, nccl),
            "drivers": phase_mesh_drivers(card, drivers, driver_singles,
                                          dict(zip(drivers, driver_ranks))),
            "cli": cli}


# -- phase 17: the HDF5 experiment monitor ------------------------------------------

MONITOR_SAMPLES = {"avmnist": {"train": 1024, "validation": 128, "test": 128},
                   "utt": {"train": 640, "validation": 64, "test": 64}}
MONITOR_STEPS = 3  # monitored float32 steps held against the CPU (the ResNets' float64: 1)
MONITOR_TOL = CPU_TOL  # GPU vs CPU records from the same state (`_stat_errors`)
MONITOR_SAME_TOL = (1e-5, 1e-4)  # the card's reductions vs the CPU's of the same tensor:
# value columns and moments (`_stat_errors`); fractions exactly
MONITOR_INTERVALS = {"unmonitored": None, "100/100": 100, "1/1": 1}  # mmtpu's defaults, every step


def monitor_configs(out_root: str) -> dict:
    """Phase 5's scratch fine-tune (ResNet18/34, batch 128) and phase 6's
    UttFusion (batch 32, T = 50), dropout 0, with MONITOR_SAMPLES, a
    `monitor_path` and `monitoring.enabled` at intervals 1 / 1."""
    cfgs = {"avmnist": train_configs(out_root)["scratch"],
            "utt": utt_train_config(out_root, dropout=False)}
    cfgs["avmnist"]["model"]["dropout"] = 0.0
    for kind, cfg in cfgs.items():
        cfg["experiment"]["name"] = cfg["model"]["name"] = f"{cfg['experiment']['name']}_Monitored"
        for split, n in MONITOR_SAMPLES[kind].items():
            cfg["data"]["datasets"][split]["kwargs"]["num_samples"] = n
        cfg["logging"]["monitor_path"] = f"{out_root}/{{experiment_name}}/monitor/{{run_id}}"
        cfg["monitoring"] = {"enabled": True, "gradient_interval": 1, "activation_interval": 1}
    return cfgs


def _monitor_loop(cfg, dev):
    """A streaming `TrainLoop` as `train_multimodal` builds it, from the
    seeded weights (drawn on the CPU: every device gets the same), its
    monitor set per epoch by the caller."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.step import ClassificationTask

    model = common.init_model(common.build_model_from_config(cfg.model), SEED, dev)
    state = common.make_state(model, cfg.training, clip=cfg.model.kwargs.get("clip"))
    state.generator = common.use_run_generator(model, SEED, dev)
    task = ClassificationTask(
        model=model, loss_group=cfg.training.loss_functions,
        input_keys=[str(m) for m in common.modalities_for_model(cfg.model.model_type)])
    return TrainLoop(task=task, state=state, loaders=common.build_all_loaders(cfg),
                     recorder=common.make_recorder(cfg),
                     checkpoint_manager=common.make_checkpoint_manager(cfg), device=dev,
                     epochs=1, device_resident="off")


def _memory_monitor(cfg, interval: int):
    """mmtpu's monitor at `interval` / `interval` over an in-memory sink (the
    card's machine has no h5py)."""
    import dataclasses

    from mmtpu_torch.monitor import ExperimentMonitor, MemoryStorage

    mc = dataclasses.replace(cfg.monitoring, gradient_interval=interval,
                             activation_interval=interval)
    return ExperimentMonitor(mc, "", storage=MemoryStorage())


def _stat_errors(got, want) -> tuple:
    """(values, fractions, moments) errors of a STAT_COLUMNS row against
    another: the value columns of the leaf's max |x| (l1 and l2, which grow
    with the element count, relative), the fractions absolute, skewness and
    kurtosis of max(1, |value|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    scale = max(abs(want[3]), abs(want[4]), 1e-30)
    values = max(d[0] / max(abs(want[0]), 1e-30), d[5] / max(abs(want[5]), 1e-30),
                 float(np.max(d[[1, 2, 3, 4, 6, 7, 8, 9, 10]])) / scale)
    return (values, float(np.max(d[[11, 12, 13, 16]])),
            float(np.max(d[14:16] / np.maximum(1.0, np.abs(want[14:16])))))


@contextlib.contextmanager
def _same_tensor_check(worst: dict):
    """While it is open, every `leaf_stats` of a CUDA tensor is also taken of
    the same tensor copied to the CPU, and `worst` keeps the largest
    `_stat_errors` of the card's row against the CPU's and counts the rows."""
    from mmtpu_torch.monitor import monitor as mon_mod

    real = mon_mod.leaf_stats

    def checked(t):
        out = real(t)
        if t.is_cuda:
            errs = _stat_errors(out.cpu().numpy(), real(t.detach().cpu()).numpy())
            for key, e in zip(("values", "fractions", "moments"), errs):
                worst[key] = max(worst[key], e)
            worst["rows"] += 1
        return out

    mon_mod.leaf_stats = checked
    try:
        yield
    finally:
        mon_mod.leaf_stats = real


def _monitored_pair(dev, cfg, float64: bool = False) -> tuple:
    """Monitored steps at intervals 1 / 1 on the card and on the CPU, each
    from the same state (the CPU's weights and Adam moments loaded on the
    card before it), then `record_weights` of the CPU's final weights on
    both: MONITOR_STEPS in float32, or one in float64. The two runs'
    records, the launches of the card's steps, and `_same_tensor_check`'s
    worst errors over the float32 run's first step and its weights (a CPU
    copy of every tensor there costs what the CPU's own capture does)."""
    import copy

    import torch

    cpu = torch.device("cpu")
    loops = {label: _monitor_loop(cfg, device) for label, device in (("gpu", dev), ("cpu", cpu))}
    for loop in loops.values():
        loop.monitor = _memory_monitor(cfg, 1)
        loop.monitor.start_epoch(1)
        if float64:
            loop.state.model.double()
    batches = list(itertools.islice(iter(loops["cpu"].loaders["train"]),
                                    1 if float64 else MONITOR_STEPS))
    gpu, host = loops["gpu"].state, loops["cpu"].state
    same = {"values": 0.0, "fractions": 0.0, "moments": 0.0, "rows": 0}
    reset_counts()
    with _float64_losses() if float64 else contextlib.nullcontext():
        for k, batch in enumerate(batches):
            batch = _as_float64(batch) if float64 else batch
            if k:
                gpu.model.load_state_dict(host.model.state_dict())
                gpu.optimizer.load_state_dict(copy.deepcopy(host.optimizer.state_dict()))
            with _same_tensor_check(same) if k == 0 and not float64 else (
                    contextlib.nullcontext()):
                loops["gpu"]._monitored_step(batch)
            loops["cpu"]._monitored_step(batch)
    torch.cuda.synchronize()
    launches = read_counts()
    gpu.model.load_state_dict(host.model.state_dict())
    with _same_tensor_check(same) if not float64 else contextlib.nullcontext():
        loops["gpu"].monitor.record_weights(gpu.model)
    loops["cpu"].monitor.record_weights(host.model)
    return ({label: loop.monitor.storage.records for label, loop in loops.items()}, launches,
            same)


@contextlib.contextmanager
def _plain_head():
    """AVMNIST's eval head on its plain chain (the kernel takes float32
    only), for a float64 pass that no launch count reads."""
    from mmtpu_torch.models import avmnist
    from mmtpu_torch.ops.fused_mlp import fused_mlp_reference

    real = avmnist.fused_mlp
    avmnist.fused_mlp = fused_mlp_reference
    try:
        yield
    finally:
        avmnist.fused_mlp = real


def _records_worst(kind: str, recs: dict, groups) -> dict:
    """The worst `_stat_errors` over the records of `groups`, card vs CPU,
    with the record that has each; raises where the names, attributes or
    shapes differ."""
    worst = {key: (0.0, "-") for key in ("values", "fractions", "moments")}
    for group in groups:
        if sorted(recs["gpu"][group]) != sorted(recs["cpu"][group]):
            raise AssertionError(f"[monitor {kind}] {group} record names differ: "
                                 f"{sorted(set(recs['gpu'][group]) ^ set(recs['cpu'][group]))}")
        for name, (want, attrs) in recs["cpu"][group].items():
            got, got_attrs = recs["gpu"][group][name]
            if got_attrs != attrs or got.shape != want.shape:
                raise AssertionError(f"[monitor {kind}] {group}/{name}: {got_attrs} {got.shape} "
                                     f"vs {attrs} {want.shape}")
            errs = (_stat_errors(got, want) if want.shape == (17,) else
                    (float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))), 0, 0))
            for key, e in zip(("values", "fractions", "moments"), errs):
                if e > worst[key][0]:
                    worst[key] = (e, f"{group}/{name}")
    return worst


def _say_worst(worst: dict) -> str:
    return ", ".join(f"{key} {e:.3e} at {where}" for key, (e, where) in worst.items())


def phase_monitor_check(dev, kind: str, cfg) -> dict:
    """`_monitored_pair` in float32: the same record names; every reduction
    the card made within MONITOR_SAME_TOL of the CPU's on the same tensor;
    `fused_mlp` once per capture forward (AVMNIST's eval head), `lstm` once
    per train step and per capture forward (UttFusion); every record within
    MONITOR_TOL of the CPU's (`_stat_errors`). For the ResNets the float32
    records are printed and the records of a float64 `_monitored_pair`
    judged: their float32 BatchNorm backward leaves either device a few
    1e-3 from the exact gradient (PERF.md §6), and their float32 forwards
    differ by up to ~8e-4 of an activation's max |x|, which the fourth
    moment amplifies past 1e-3."""
    groups = ["gradients", "activations", "weights", "convergence"]
    recs, launches, same = _monitored_pair(dev, cfg)
    f32 = _records_worst(kind, recs, groups)
    f64 = None
    if kind == "avmnist":
        with _plain_head():
            f64 = _records_worst(kind, _monitored_pair(dev, cfg, float64=True)[0], groups)
    counts = {g: len(r) for g, r in recs["cpu"].items()}
    want_launches = ({"fused_mlp": MONITOR_STEPS, "lstm": 0} if kind == "avmnist"
                     else {"fused_mlp": 0, "lstm": 2 * MONITOR_STEPS})
    say(f"[monitor {kind}] {MONITOR_STEPS} monitored steps (intervals 1 / 1) and the weights, "
        f"card vs CPU from the same state: records {counts}, names equal; worst in float32 "
        f"{_say_worst(f32)}" + (f"; in float64 (one step and the weights) {_say_worst(f64)}"
                                if f64 else "")
        + f" (tolerance {MONITOR_TOL}: value columns of the leaf's max |x|, l1 and l2 relative; "
        f"fractions; moments relative); the card's reductions vs the CPU's of the same "
        f"{same['rows']} tensors (step 1's and the weights): values {same['values']:.3e}, fractions "
        f"{same['fractions']:.3e}, moments {same['moments']:.3e} (tolerances "
        f"{MONITOR_SAME_TOL}, fractions exact); launches {launches} (expected {want_launches})")
    if max(e for e, _ in (f64 or f32).values()) > MONITOR_TOL:
        raise AssertionError(f"[monitor {kind}] card vs CPU records: {f64 or f32}")
    if (same["values"] > MONITOR_SAME_TOL[0] or same["moments"] > MONITOR_SAME_TOL[1]
            or same["fractions"] > 0):
        raise AssertionError(f"[monitor {kind}] the card's reductions: {same}")
    if launches != want_launches:
        raise AssertionError(f"[monitor {kind}] launches {launches}, expected {want_launches}")
    return {"records": counts, "float32": {k: v[0] for k, v in f32.items()},
            "float64": f64 and {k: v[0] for k, v in f64.items()}, "same": same,
            "launches": launches}


def phase_monitor_cost(dev, card: str, kind: str, cfg) -> dict:
    """One streaming train epoch each unmonitored, at mmtpu's default
    intervals (100 / 100) and at 1 / 1, after an unmonitored warm-up epoch,
    all on one model: samples/s, records per step, the launches of the 1 / 1
    epoch and a streamed validation epoch (`fused_mlp` once per eval step
    and per capture; `lstm` once per train and eval step and per capture),
    and one profiled capture of each kind (its host share)."""
    import torch

    loop = _monitor_loop(cfg, dev)
    train, val = loop.loaders["train"], loop.loaders["validation"]
    steps, eval_steps = len(train), len(val)
    loop.train_epoch(1)  # warm-up: cuDNN plans, the allocator
    out = {"samples_per_s": {}}
    for epoch, (label, interval) in enumerate(MONITOR_INTERVALS.items(), start=2):
        loop.monitor = None if interval is None else _memory_monitor(cfg, interval)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loop.train_epoch(epoch)
        torch.cuda.synchronize()
        out["samples_per_s"][label] = MONITOR_SAMPLES[kind]["train"] / (time.perf_counter() - t0)
        loop.eval_epoch("validation")
        torch.cuda.synchronize()
        launches = read_counts()
        loop.recorder.reset()
        captures = 0 if interval is None else -(-steps // interval)
        want = ({"fused_mlp": eval_steps + captures, "lstm": 0} if kind == "avmnist" else
                {"fused_mlp": 0, "lstm": steps + eval_steps + captures})
        if launches != want:
            raise AssertionError(f"[monitor {kind} {label}] launches {launches}, expected {want}")
        out.setdefault("launches", {})[label] = launches
    mon = loop.monitor  # 1 / 1
    recs = mon.storage.records
    per = {g: len(recs[g]) / steps for g in ("gradients", "activations")}
    out["records_per_step"] = sum(per.values())
    out["weight_records"] = len(recs["weights"])
    batch = next(iter(train))
    loop.train_step(batch)
    model = loop.state.model
    inputs = [torch.from_numpy(batch[k]).to(dev) for k in loop.task.input_keys]
    shares = {}
    for what, fn in (("gradients", lambda: mon.record_gradients(model)),
                     ("activations", lambda: mon.record_activations(model, inputs))):
        brk = device_breakdown(fn)
        shares[what] = {"wall_ms": brk["profiled_wall_ms"], "device_ms": brk["device_ms"],
                        "host_share": 1.0 - brk["device_ms"] / brk["profiled_wall_ms"],
                        "kernels": brk["kernel_events"]}
    out["capture"] = shares
    sps = out["samples_per_s"]
    say_card(card, f"[monitor {kind}] streaming train epoch of {steps} steps: "
             + ", ".join(f"{k} {v:.1f}" for k, v in sps.items()) + " samples/s; "
             f"{out['records_per_step']:.1f} records per step at 1 / 1 "
             f"({per['gradients']:.0f} gradients, {per['activations']:.0f} activations) and {out['weight_records']} weight records an epoch; launches "
             f"{out['launches']} (with a streamed validation epoch of {eval_steps} steps); one "
             "capture: " + "; ".join(
                 f"{w} {s['wall_ms']:.2f} ms wall, {s['device_ms']:.2f} ms device in "
                 f"{s['kernels']} kernels, host share {s['host_share']:.3f}"
                 for w, s in shares.items()))
    return out


def phase_monitor_h5py(card: str, work: Path, cfg_path: Path) -> dict:
    """`train_multimodal.main` with `monitoring.enabled: true`: without h5py
    it must stop before its first step (no launch, no epoch record) with
    the error that names h5py; with h5py it writes the file."""
    import importlib.util

    from mmtpu_torch.cli import train_multimodal

    if importlib.util.find_spec("h5py") is None:
        reset_counts()
        try:
            train_multimodal.main(["--config", str(cfg_path), "--run_id", "1"])
        except ImportError as e:
            if "h5py" not in str(e):
                raise
            message = str(e)
        else:
            raise AssertionError("[monitor] train_multimodal trained without h5py")
        if read_counts() != {"fused_mlp": 0, "lstm": 0} or list(work.rglob("epoch_metrics.json")):
            raise AssertionError(f"[monitor] a step ran before the error: {read_counts()}")
        say(f"[monitor] no h5py on this machine: train_multimodal.main stopped before its first "
            f"step: {message}")
        return {"h5py": False}
    if train_multimodal.main(["--config", str(cfg_path), "--run_id", "1"]) != 0 or not list(
            work.rglob("monitor_data.h5")):
        raise AssertionError("[monitor] train_multimodal wrote no monitor_data.h5")
    say("[monitor] h5py present: train_multimodal.main wrote monitor_data.h5")
    return {"h5py": True}


def phase17(dev, card: str, work: Path) -> dict:
    """(a) the AVMNIST fine-tune and (b) UttFusion: the monitor's records on
    the card against the CPU, its cost, and the CLI's stop without h5py."""
    from mmtpu_torch.cli import common

    _tf32_off()
    out = {}
    paths = {}
    for kind, raw in monitor_configs(str(work / "monitor")).items():
        paths[kind] = work / f"monitor_{kind}.json"
        paths[kind].write_text(json.dumps(raw))
        cfg = common.load_config(argparse.Namespace(config=str(paths[kind]), run_id=1, seed=None))
        t0 = time.perf_counter()
        check = phase_monitor_check(dev, kind, cfg)
        t1 = time.perf_counter()
        out[kind] = {"check": check, "cost": phase_monitor_cost(dev, card, kind, cfg)}
        say(f"[monitor {kind}] check {t1 - t0:.1f} s, cost {time.perf_counter() - t1:.1f} s")
    out["cli"] = phase_monitor_h5py(card, work / "monitor", paths["utt"])
    return out


def say_phase17(card: str, p17: dict, seconds: float) -> None:
    for kind, label in (("avmnist", "AVMNIST fine-tune, B=128"), ("utt", "UttFusion, B=32")):
        r = p17[kind]
        cap = r["cost"]["capture"]
        say_card(card, f"[summary] monitor {label}: train samples/s "
                 + ", ".join(f"{k} {v:.1f}" for k, v in r["cost"]["samples_per_s"].items())
                 + f"; {r['cost']['records_per_step']:.1f} records per step at 1 / 1; capture "
                 f"host share gradients {cap['gradients']['host_share']:.3f}, activations "
                 f"{cap['activations']['host_share']:.3f}; card vs CPU worst in float32 "
                 + ", ".join(f"{k} {v:.3e}" for k, v in r["check"]["float32"].items())
                 + ("" if r["check"]["float64"] is None else "; in float64 " + ", ".join(
                     f"{k} {v:.3e}" for k, v in r["check"]["float64"].items()))
                 + f"; launches {r['check']['launches']} in {MONITOR_STEPS} steps")
    say(f"[summary] monitor without h5py: "
        f"{'the CLI stops before its first step' if not p17['cli']['h5py'] else 'h5py present'}"
        f"; phase 17 {seconds:.1f} s")


# -- phase 18: the model axis, and UMAP on the card ------------------------------------

AXIS_MESH = (2, 2)  # (data_parallel, model_parallel): four ranks sharing cuda:0 over gloo
AXIS_STEPS = 3  # float32 train steps held against one process
AXIS_EVAL_STEPS = 1  # eval steps of the test split (B = 128); one, for the script's room
AXIS_LOGIT_TOL = 1e-4  # eval logits, the (2, 2) mesh vs one process, float32
AXIS_SHAPES = ([192, 64, 64], [64, 10])  # a rank's shard pair at mp = 2, and the tail
UMAP_SHAPE = (3000, 192, 10)  # points (the AVMNIST test pass), width, classes
UMAP_FUZZY_TOL = 1e-6  # the fuzzy set's weights, card vs CPU
UMAP_LAYOUT_TOL = 1e-4  # the float64 layout, card vs CPU, over the held epochs
UMAP_EPOCHS = (1, 2, 3)  # each held point for point:
# the repulsive steps amplify an ulp tenfold to a hundredfold per epoch (PERF.md §6)


def axis_config(work: Path) -> Path:
    """Phase 15's scratch fine-tune at full width (ResNet18 / ResNet34, head
    192-128-64-10), dropout 0, as JSON."""
    cfg = train_configs(str(work / "axis"))["scratch"]
    cfg["model"]["dropout"] = 0.0
    path = work / "axis.json"
    path.write_text(json.dumps(cfg))
    return path


def _axis_model(cfg, dev, init: Optional[dict] = None):
    """The fine-tune's whole model on `dev` (every rank the same): from the
    seed, or holding `init` (a state_dict of it)."""
    from mmtpu_torch.cli import common

    model = common.build_model_from_config(cfg.model)
    if init is None:
        return common.init_model(model, SEED, dev)
    model.load_state_dict(init)
    return model.to(dev)


def _axis_setup(cfg, model, mesh):
    """`model` with its head sharded over `mesh`'s model axis; its state and
    task."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.models.avmnist import AVMNIST
    from mmtpu_torch.parallel.tensor import shard_module
    from mmtpu_torch.train.step import ClassificationTask

    if mesh is not None:
        shard_module(model, mesh, AVMNIST.TENSOR_PARALLEL_RULE)
    state = common.make_state(model, cfg.training)
    state.mesh = mesh
    return model, state, ClassificationTask(model=model, loss_group=cfg.training.loss_functions,
                                            input_keys=["audio", "image"])


def _replicated_hash(model) -> str:
    from mmtpu_torch.parallel.tensor import shard_dims

    dims = shard_dims(model)
    return _state_hash({k: v for k, v in model.state_dict().items() if k not in dims})


def _whole_grads(model) -> dict:
    """Every parameter's gradient as one process holds it: a shard's joined
    over the model group (collective on a model axis)."""
    from mmtpu_torch.parallel.tensor import join_shards, shard_dims, sharding

    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    sh, dims = sharding(model), shard_dims(model)
    if sh is not None:
        grads.update(join_shards(sh.mesh.model_gather({k: grads[k] for k in dims}), dims))
    return grads


def _axis_job(job: dict) -> int:
    """Phase 18 (a) in one process: a rank of the (2, 2) mesh (the launcher
    runs it there) or the single process. From the seeded weights,
    AXIS_EVAL_STEPS eval steps (global logits, `fused_mlp` launches) and
    the shard pair's kernel against its plain version; then the fine-tune's
    first AXIS_STEPS float32 steps (global losses, each step's wall time,
    the replicated parameters' sha256, the model-group all-reduce's bytes),
    the gathered state after steps 1 and 3, a checkpoint every rank saves
    (who wrote it) and reads back into its shards; a float64 step from the
    seeded weights (the gathered gradients and parameters). To
    `<out>/<rank or single>.pt`."""
    import itertools as it

    import torch

    from mmtpu_torch.checkpoints.manager import CheckpointManager
    from mmtpu_torch.cli import common
    from mmtpu_torch.ops import fused_mlp, fused_mlp_reference
    from mmtpu_torch.parallel.mesh import get_default_mesh
    from mmtpu_torch.parallel.tensor import gather_state_dict, sharding
    from mmtpu_torch.train.step import make_eval_step, make_train_step

    mesh = get_default_mesh()
    dev = mesh.device if mesh is not None else torch.device(MESH_DEVICE)
    _cudnn(True)
    _tf32_off()
    cfg, batches = _train_batches(Path(job["cfg"]), AXIS_STEPS)
    tests = list(it.islice(cfg.data.build_loader("test", seed=cfg.experiment.seed),
                           AXIS_EVAL_STEPS))
    rec = {"losses": [], "step_s": [], "hashes": [], "reduce_bytes": [], "states": {}}

    def gathered(value):
        return value if mesh is None else mesh.gather(value)

    model = _axis_model(cfg, dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model, state, task = _axis_setup(cfg, model, mesh)
    nbytes = [0]
    if mesh is not None:
        reduce_model = mesh.model_all_reduce_

        def counted(t):
            nbytes[0] += t.numel() * t.element_size()
            return reduce_model(t)

        mesh.model_all_reduce_ = counted
    evaluate = make_eval_step(task, dev, mesh)
    reset_counts()
    outs = [evaluate(b) for b in tests]
    torch.cuda.synchronize()
    rec["eval_launches"] = read_counts()["fused_mlp"]
    rec["logits"] = [np.concatenate(gathered(o["logits"].cpu().numpy())) if mesh is not None
                     else o["logits"].cpu().numpy() for o in outs]
    sh = sharding(model)
    if sh is not None:
        with torch.inference_mode():
            from mmtpu_torch.train.step import apply_missing_mask, rows_on_device

            b, _ = rows_on_device(tests[0], mesh, dev)
            model.eval()
            x = torch.cat(model.encode(*(apply_missing_mask(b[k], b[f"{k}_mask"])
                                         for k in ("audio", "image"))), dim=1).contiguous()
            w = [model.fc_fusion.weight, model.fc_intermediate.weight]
            bias = [model.fc_fusion.bias, torch.zeros_like(model.fc_intermediate.bias)]
            got, want = fused_mlp(x, w, bias), fused_mlp_reference(x, w, bias)
            torch.cuda.synchronize()
            rec["shard_err"] = (got - want).abs().max().item()
            rec["shard_shape"] = [x.shape[0], x.shape[1], *(t.shape[0] for t in w)]

    step = make_train_step(task, state, dev)
    for i, batch in enumerate(batches):
        nbytes[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch)["loss"])
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        rec["losses"].append(float(sum(gathered(loss))) if mesh is not None else loss)
        rec["hashes"].append(_replicated_hash(model))
        rec["reduce_bytes"].append(nbytes[0])
        if i in (0, AXIS_STEPS - 1):
            whole = gather_state_dict(model)
            if mesh is None or mesh.is_writer:
                rec["states"][i + 1] = whole
    if mesh is not None:
        saved = []
        real_save = torch.save

        def save(obj, f, *args, **kwargs):
            if isinstance(f, (str, Path)):
                saved.append(str(f))
            return real_save(obj, f, *args, **kwargs)

        ckpt = CheckpointManager(Path(job["out"]) / "ckpt")
        torch.save = save
        try:
            ckpt.save_checkpoint(state, AXIS_STEPS, 0.0)
        finally:
            torch.save = real_save
        mesh.barrier()
        own = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        ckpt.load_checkpoint(state, "best")
        rec["saved"] = saved
        rec["restored"] = all(torch.equal(v, own[k]) for k, v in model.state_dict().items())

    model, state, task = _axis_setup(cfg, _axis_model(cfg, dev, init).double(), mesh)
    with _float64_losses():
        make_train_step(task, state, dev)(_as_float64(batches[0]))
    grads, whole = _whole_grads(model), gather_state_dict(model)
    if mesh is None or mesh.is_writer:
        rec["grads64"], rec["state64"] = grads, whole
    torch.save(rec, Path(job["out"]) / (f"rank{mesh.rank}.pt" if mesh else "single.pt"))
    return 0


def _axis_kernel_shapes(dev, card: str) -> dict:
    """The shard pair's chain and the one-layer tail on the card at a data
    rank's B = 64 (a streamed batch of 128) and 512 (a fused step of 1024):
    each against its plain version, and its time beside the plain chain's,
    its bound and, for the tail, the one library call that computes it
    (`torch.addmm`, x·Wᵀ + b; the pair has none)."""
    import torch

    from mmtpu_torch.ops import fused_mlp, fused_mlp_reference

    g = torch.Generator().manual_seed(SEED + 18)
    out = {}
    for dims in AXIS_SHAPES:
        ws = [(torch.randn(o, i, generator=g) / i ** 0.5).to(dev)
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [(0.1 * torch.randn(o, generator=g)).to(dev) for o in dims[1:]]
        for batch in MESH_MLP_BATCHES:
            x = torch.randn(batch, dims[0], generator=g).to(dev)
            err = (fused_mlp(x, ws, bs) - fused_mlp_reference(x, ws, bs)).abs().max().item()
            p1 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
            k1 = event_ms(lambda: fused_mlp(x, ws, bs))
            k2 = event_ms(lambda: fused_mlp(x, ws, bs))
            p2 = event_ms(lambda: fused_mlp_reference(x, ws, bs))
            kd = own_device_ms(lambda: fused_mlp(x, ws, bs), "fused_mlp")
            pd = device_breakdown(lambda: [fused_mlp_reference(x, ws, bs)
                                           for _ in range(100)])["device_ms"] / 100
            bound, bound_by = mlp_bound_ms(batch, dims)
            out[f"{dims} B={batch}"] = t = {
                "ms": statistics.mean([k1, k2]), "plain_ms": statistics.mean([p1, p2]),
                "device_ms": kd, "plain_device_ms": pd, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None, "library_device_ms": None,
                "max_abs_err": err}
            line = (f"[axis] fused_mlp {dims} B={batch}: max |kernel - plain| {err:.3e}; per "
                    f"call kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms; device "
                    f"kernel {kd:.6f} ms, plain {pd:.6f} ms; bound {bound:.6f} ms ({bound_by})")
            if len(ws) == 1:
                def library():
                    return torch.addmm(bs[0], x, ws[0].t())

                diff = (library() - fused_mlp_reference(x, ws, bs)).abs().max().item()
                if diff > LIBRARY_TOL:
                    raise AssertionError(f"torch.addmm {dims} B={batch}: differs by {diff}")
                l1, l2 = event_ms(library), event_ms(library)
                ld = device_breakdown(lambda: [library() for _ in range(100)])["device_ms"] / 100
                t.update(library_ms=statistics.mean([l1, l2]), library_device_ms=ld)
                line += (f"; torch.addmm {l1:.4f}/{l2:.4f} ms, device {ld:.6f} ms, max "
                         f"|difference| {diff:.3e}")
            say_card(card, line)
            if err > KERNEL_TOL:
                raise AssertionError(f"fused_mlp {dims} B={batch}: error {err}")
    return out


def phase_model_axis(dev, card: str, work: Path) -> dict:
    """Phase 18 (a): the full-width AVMNIST fine-tune on a (2, 2) mesh, four
    ranks on cuda:0 over gloo, its head tensor-parallel, against one
    process from the same seeded weights (dropout 0, TF32 off, cuDNN
    deterministic): the eval logits from the seeded weights within 1e-4 and
    the predictions equal where the top-2 margin is above 1e-3; `fused_mlp`
    exactly 2 launches per eval step per rank (1 in one process); the shard
    pair's kernel within 1e-5 of its plain version; float32 losses of step 1
    within 1e-4 and steps 2-3 within 1e-3; the float64 step-1 gradients,
    gathered, within 1e-6 of each parameter's norm, and the parameters after
    it; the float32 parameters, gathered, printed (Adam moves an element
    whose gradient is near 0 by ±lr on either side); a model group's
    replicated parameters bit-identical after every step; rank 0 alone
    writes the checkpoint, which holds the whole model and which every rank
    reads back into its shards."""
    import torch

    from mmtpu_torch.parallel import MeshConfig, create_mesh
    from mmtpu_torch.parallel.launch import launch

    cfg = axis_config(work)
    outs = {}
    for tag in ("single", "mesh"):
        outs[tag] = work / f"axis_{tag}"
        outs[tag].mkdir()
    t0 = time.perf_counter()
    dp, mp = AXIS_MESH
    mesh = create_mesh(MeshConfig(dp, mp), devices=[torch.device(MESH_DEVICE)] * (dp * mp))
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    # the single process runs on a thread while the ranks start and run:
    # its numbers are the reference, its step times only printed
    with ThreadPoolExecutor(1) as pool:
        single = pool.submit(_axis_job, {"cfg": str(cfg), "out": str(outs["single"])})
        rc = launch(mesh, _axis_job, ({"cfg": str(cfg), "out": str(outs["mesh"])},),
                    timeout=MESH_TIMEOUT_S)
        if single.result() != 0:
            raise AssertionError("[axis] the single process failed")
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags
    if rc != 0:
        raise AssertionError(f"[axis] a rank exited with code {rc}")
    t2 = time.perf_counter()
    one = torch.load(outs["single"] / "single.pt", weights_only=False)
    ranks = [torch.load(outs["mesh"] / f"rank{r}.pt", weights_only=False)
             for r in range(dp * mp)]

    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one["losses"])]
    groups = [[r["hashes"] for r in ranks[d * mp:(d + 1) * mp]] for d in range(dp)]
    if any(h != g[0] for g in groups for h in g):
        raise AssertionError(f"[axis] a model group's replicated parameters differ: {groups}")
    grad_err = _grad_errors(ranks[0]["grads64"], one["grads64"])
    param64 = _grad_errors(*({k: v for k, v in st.items() if v.is_floating_point()}
                             for st in (ranks[0]["state64"], one["state64"])))
    param32 = {s: _whole_error(ranks[0]["states"][s], one["states"][s]) for s in one["states"]}
    ckpt = torch.load(outs["mesh"] / "ckpt" / "best.pth", weights_only=True)
    if not torch_equal(ckpt["model"], ranks[0]["states"][AXIS_STEPS]):
        raise AssertionError("[axis] the checkpoint is not the gathered state")
    if [Path(p).name for p in ranks[0]["saved"]] != ["epoch_3.pth.tmp", "best.pth.tmp"] or any(
            r["saved"] for r in ranks[1:]) or not all(r["restored"] for r in ranks):
        raise AssertionError(f"[axis] writes {[r['saved'] for r in ranks]}, restored "
                             f"{[r['restored'] for r in ranks]}")
    logits = np.concatenate(ranks[0]["logits"])
    ref = np.concatenate(one["logits"])
    logit_err = float(np.abs(logits - ref).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN
    flips = int((logits.argmax(1) != ref.argmax(1))[clear].sum())
    shard_err = max(r["shard_err"] for r in ranks)
    launches = [r["eval_launches"] for r in ranks]
    step_ms = [[round(s * 1e3, 3) for s in r["step_s"]] for r in ranks]
    say(f"[axis] {dp * mp} ranks, a ({dp}, {mp}) mesh on {MESH_DEVICE} over gloo, beside "
        f"the single process on a thread: {t2 - t0:.1f} s (process start-up included)")
    say(f"[axis] train losses of steps 1-{AXIS_STEPS}: one process {one['losses']}, the mesh "
        f"{ranks[0]['losses']}, relative {rel} (tolerances {TRAIN_LOSS_RTOL}, "
        f"{TRAIN_LATER_RTOL}); gathered float32 parameters after steps "
        f"{sorted(param32)} {[param32[s] for s in sorted(param32)]} of the model's norm "
        f"(printed: Adam moves an element whose gradient is near 0 by ±lr on either side)")
    say(f"[axis] float64 step 1: gradients worst {max(grad_err.values()):.3e} of a "
        f"parameter's norm, {_worst(grad_err)}; parameters worst "
        f"{max(param64.values()):.3e} (tolerance {TRAIN_GRAD64_TOL})")
    say(f"[axis] eval from the seeded weights over {AXIS_EVAL_STEPS} test steps ({len(ref)} "
        f"rows): logits "
        f"{logit_err:.3e} (tolerance {AXIS_LOGIT_TOL}), {flips} clear predictions differ "
        f"({int(clear.sum())} clear of {len(ref)}); fused_mlp launches per rank {launches}, "
        f"one process {one['eval_launches']}; the shard pair {ranks[0]['shard_shape']} "
        f"kernel vs plain {shard_err:.3e} (tolerance {KERNEL_TOL})")
    say(f"[axis] replicated parameters' sha256 per step equal within each model group; "
        f"rank 0 wrote {[Path(p).name for p in ranks[0]['saved']]}, ranks 1-3 nothing; every "
        f"rank read its shards back")
    say_card(card, f"[axis] step wall times per rank (ms; four processes sharing one card, "
             f"not a scaling number) {step_ms}, the single process beside them "
             f"{[round(s * 1e3, 3) for s in one['step_s']]}; model-group all-reduce bytes per "
             f"train step per rank {ranks[0]['reduce_bytes']}")
    if rel[0] > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[axis] losses {rel}")
    if max(grad_err.values()) > TRAIN_GRAD64_TOL or max(param64.values()) > TRAIN_GRAD64_TOL:
        raise AssertionError(f"[axis] float64 gradients {_worst(grad_err)}, parameters "
                             f"{_worst(param64)}")
    if logit_err > AXIS_LOGIT_TOL or flips or shard_err > KERNEL_TOL:
        raise AssertionError(f"[axis] logits {logit_err}, flips {flips}, shard {shard_err}")
    if launches != [2 * AXIS_EVAL_STEPS] * (dp * mp) or one["eval_launches"] != AXIS_EVAL_STEPS:
        raise AssertionError(f"[axis] fused_mlp launches {launches}, one process "
                             f"{one['eval_launches']}")
    return {"loss_rel": rel, "grad_err": max(grad_err.values()),
            "param64": max(param64.values()), "param32": param32, "logit_err": logit_err,
            "shard_err": shard_err, "launches_per_eval_step": launches[0] // AXIS_EVAL_STEPS,
            "step_ms": step_ms, "reduce_bytes": ranks[0]["reduce_bytes"], "seconds": t2 - t0}


def umap_points(seed: int = SEED) -> tuple:
    """UMAP_SHAPE's seeded embeddings: one Gaussian cloud per class (the
    AVMNIST test pass's 3,000 rows of a 192-wide fused embedding, ten
    digits), and their labels."""
    n, d, classes = UMAP_SHAPE
    g = np.random.default_rng(seed)
    labels = np.arange(n) % classes
    centers = g.normal(scale=3.0, size=(classes, d))
    return (centers[labels] + g.normal(size=(n, d))).astype(np.float32), labels


def phase_umap(dev, card: str) -> dict:
    """Phase 18 (b): `umap_embed`'s steps on the card against the port on
    the CPU over UMAP_SHAPE's embeddings: the kNN indices equal, the fuzzy
    set within 1e-6; the layout in float64 from the same start and
    negative samples within 1e-4 after each of the first three epochs; the
    200-epoch projection's wall time on the card."""
    import torch

    from mmtpu_torch.analysis import umap_lite as U

    x, _ = umap_points()
    k = 15
    graphs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        idx, dist = U._knn(torch.from_numpy(x).to(d), k)
        graphs[name] = (idx.cpu(), *(t.cpu() for t in U._fuzzy_simplicial_set(idx, dist)))
    (ci, ch, ct, cw), (hi, hh, ht, hw) = graphs["card"], graphs["cpu"]
    same = torch.equal(ci, hi) and torch.equal(ch, hh) and torch.equal(ct, ht)
    fuzzy = (cw - hw).abs().max().item() if same else float("inf")
    a, b = U._find_ab(0.1)
    start = U._pca_start(x, 2)
    weight = hw.numpy()
    keep = weight > weight.max() / 200
    sel = torch.from_numpy(np.flatnonzero(keep))
    head, tail = hh[sel], ht[sel]
    drift = []
    for epochs in UMAP_EPOCHS:
        runs = [U._layout(torch.from_numpy(start).double().to(d), head.to(d), tail.to(d),
                          weight[keep], a, b, 200, 1.0, 5, np.random.default_rng(SEED),
                          epochs=epochs).cpu() for d in (dev, torch.device("cpu"))]
        drift.append((runs[0] - runs[1]).abs().max().item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = U.umap_embed(x, random_state=SEED, device=dev)
    wall = time.perf_counter() - t0
    if emb.shape != (len(x), 2) or not np.isfinite(emb).all():
        raise AssertionError(f"[umap] bad projection {emb.shape}")
    say(f"[umap] {UMAP_SHAPE[0]} x {UMAP_SHAPE[1]} seeded embeddings, {len(cw)} fuzzy edges, "
        f"{int(keep.sum())} kept: kNN and edges equal card vs CPU {same}; fuzzy set "
        f"{fuzzy:.3e} (tolerance {UMAP_FUZZY_TOL}); float64 layout card vs CPU after epochs "
        f"{UMAP_EPOCHS}: {[float(f'{v:.3e}') for v in drift]} (tolerance {UMAP_LAYOUT_TOL} "
        f"over the first three)")
    say_card(card, f"[umap] 200 epochs on the card, kNN to layout: {wall:.3f} s")
    if not same or fuzzy > UMAP_FUZZY_TOL or max(drift[:3]) > UMAP_LAYOUT_TOL:
        raise AssertionError(f"[umap] graph equal {same}, fuzzy {fuzzy}, layout {drift}")
    return {"fuzzy": fuzzy, "drift": drift, "wall": wall, "edges": len(cw)}


def phase18(dev, card: str, work: Path) -> dict:
    """(a); the shard shapes' kernel times; (b)."""
    return {"axis": {**phase_model_axis(dev, card, work),
                     "shapes": _axis_kernel_shapes(dev, card)},
            "umap": phase_umap(dev, card)}


def say_phase18(card: str, p18: dict, seconds: float) -> None:
    a, u = p18["axis"], p18["umap"]
    say_card(card, f"[summary] model axis, a {AXIS_MESH} mesh on one card vs one process: "
             f"steps 1-{AXIS_STEPS} {a['loss_rel']}, float64 gradients {a['grad_err']:.3e}, "
             f"parameters {a['param64']:.3e}, float32 parameters {a['param32']}, eval logits "
             f"{a['logit_err']:.3e}; fused_mlp {a['launches_per_eval_step']} per eval step per "
             f"rank, the shard pair {a['shard_err']:.3e}; step ms per rank {a['step_ms']}; "
             f"model-group all-reduce bytes per step {a['reduce_bytes']}; (a) "
             f"{a['seconds']:.1f} s")
    say_card(card, f"[summary] UMAP card vs CPU: fuzzy set {u['fuzzy']:.3e}, float64 layout "
             f"after epochs {UMAP_EPOCHS} {[float(f'{v:.3e}') for v in u['drift']]}; 200 "
             f"epochs on the card "
             f"{u['wall']:.3f} s; phase 18 {seconds:.1f} s")


# -- phase 19: the (2, 2) mesh of separately started processes -------------------------

MULTIHOST_PROCESSES = 2  # separately started launchers of two ranks each, all on cuda:0
MULTIHOST_UNTIMED = {"step_s", "saved"}  # wall times; paths (their names compared)


def _multihost_worker(spec: dict) -> int:
    """One launcher of phase 19 (`--axis-worker SPEC`): its ranks of 18 (a)'s
    (2, 2) mesh through `launch_process`, meeting the other launcher's at
    the coordinator; 18 (a)'s job in each."""
    import torch

    from mmtpu_torch.parallel import MeshConfig
    from mmtpu_torch.parallel.launch import launch_process, process_mesh

    dp, mp = AXIS_MESH
    local = dp * mp // spec["processes"]
    mesh = process_mesh(MeshConfig(dp, mp), spec["processes"],
                        [torch.device(MESH_DEVICE)] * local)
    return launch_process(mesh, _axis_job, ({"cfg": spec["cfg"], "out": spec["out"]},),
                          coordinator=spec["coordinator"], num_processes=spec["processes"],
                          process_id=spec["process_id"], timeout=MESH_TIMEOUT_S)


def _bitwise(a, b) -> bool:
    """`a` and `b` equal bit for bit: tensors, arrays, numbers, containers."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    return a == b


def phase19(dev, card: str, work: Path) -> dict:
    """Phase 19: 18 (a)'s full-width job on its (2, 2) mesh, now made of two
    separately started launchers (`chip_smoke.py --axis-worker`, each
    `launch_process` of two ranks on cuda:0, meeting at a TCP store on a
    free local port, gloo): every rank's record (eval logits and launches,
    the shard pair's error, the float32 losses, the replicated parameters'
    sha256 per step, the model group's bytes, the gathered states, the
    float64 gradients and parameters, the checkpoint's writer and read-back)
    bit for bit 18 (a)'s single launch's, read from 18 (a)'s files; so
    within 18 (a)'s tolerances of its one-process reference; `fused_mlp`
    exactly 2 per eval step per rank."""
    import torch

    from mmtpu_torch.parallel.multihost import free_port, wait_workers

    dp, mp = AXIS_MESH
    out = work / "axis_multihost"
    out.mkdir()
    spec = {"processes": MULTIHOST_PROCESSES, "coordinator": f"127.0.0.1:{free_port()}",
            "cfg": str(work / "axis.json"), "out": str(out)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--axis-worker",
                               json.dumps({**spec, "process_id": p})],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in range(MULTIHOST_PROCESSES)]
    outs = wait_workers(procs, MESH_TIMEOUT_S + 60)
    seconds = time.perf_counter() - t0
    for p, (rc, _, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"[multihost] launcher {p} exited with {rc}:\n{err[-3000:]}")
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(dp * mp)]
    once = [torch.load(work / "axis_mesh" / f"rank{r}.pt", weights_only=False)
            for r in range(dp * mp)]
    one = torch.load(work / "axis_single" / "single.pt", weights_only=False)
    differ = {r: sorted(k for k in once[r] if k not in MULTIHOST_UNTIMED
                        and not _bitwise(got[r].get(k), once[r][k])) for r in range(dp * mp)}
    names = [[Path(f).name for f in r["saved"]] for r in got]
    rel = [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], one["losses"])]
    launches = [r["eval_launches"] for r in got]
    step_ms = [[round(t * 1e3, 3) for t in r["step_s"]] for r in got]
    say(f"[multihost] {MULTIHOST_PROCESSES} separately started launchers x "
        f"{dp * mp // MULTIHOST_PROCESSES} ranks, a ({dp}, {mp}) mesh on {MESH_DEVICE} over "
        f"gloo at {spec['coordinator']}: {seconds:.1f} s (process start-up included)")
    say(f"[multihost] every rank's record against 18 (a)'s single launch, bit for bit: "
        f"keys that differ per rank {differ}; losses {got[0]['losses']} (one process "
        f"{one['losses']}, relative {rel}); model-group bytes per train step "
        f"{got[0]['reduce_bytes']}; fused_mlp launches per rank {launches} over "
        f"{AXIS_EVAL_STEPS} eval step(s); rank 0 wrote {names[0]}, ranks 1-3 "
        f"{names[1:]}")
    say_card(card, f"[multihost] step wall times per rank (ms; four processes of two "
             f"launchers sharing one card) {step_ms}")
    if any(differ.values()):
        raise AssertionError(f"[multihost] not 18 (a)'s records: {differ}")
    if names[0] != ["epoch_3.pth.tmp", "best.pth.tmp"] or any(names[1:]):
        raise AssertionError(f"[multihost] writers {names}")
    if launches != [2 * AXIS_EVAL_STEPS] * (dp * mp):
        raise AssertionError(f"[multihost] fused_mlp launches {launches}")
    if rel[0] > TRAIN_LOSS_RTOL or max(rel[1:]) > TRAIN_LATER_RTOL:
        raise AssertionError(f"[multihost] losses {rel}")
    return {"seconds": seconds, "launches_per_eval_step": launches[0] // AXIS_EVAL_STEPS,
            "loss_rel": rel, "reduce_bytes": got[0]["reduce_bytes"], "step_ms": step_ms,
            "shard_err": max(r["shard_err"] for r in got)}


def say_phase19(card: str, p19: dict, seconds: float) -> None:
    say_card(card, f"[summary] a ({AXIS_MESH[0]}, {AXIS_MESH[1]}) mesh of "
             f"{MULTIHOST_PROCESSES} separately started launchers: bit for bit 18 (a)'s "
             f"single launch; losses vs one process {p19['loss_rel']}; fused_mlp "
             f"{p19['launches_per_eval_step']} per eval step per rank; model-group bytes per "
             f"step {p19['reduce_bytes']}; step ms per rank {p19['step_ms']}; launchers "
             f"{p19['seconds']:.1f} s; phase 19 {seconds:.1f} s")


def kernel_record(name: str, source: str, replaces: str, shape: str, kern: dict, t: dict,
                  pred: dict, srv: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": pred["launches"],
        "serve_launches": srv["launches"],
        "max_abs_err": kern["max_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "host_ms": t["host_ms"],
        "op_host_ms": t["op_host_ms"],
        "direct_host_ms": t["direct_host_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"),
        "shape": shape,
    }


# the shape at which each wide design's `kernels` entry gives its times: the
# GCNet fusion layer's (phase 14 runs it 4 times a forward) and SeqEncoder's
# text stream (phase 13 (c))
WIDE_RECORD_SHAPES = {"cluster": (2, 16, 110, 300), "grid": (2, 128, 64, 1024)}


def wide_record(design: str, lstm: dict, shape: tuple) -> dict:
    """The `kernels` entry of a wide design of csrc/lstm_wide.cu. Its launches
    are those of the paths that run it (WIDE_LAUNCHES; the main path's H = 64
    takes the narrow design); it fails if they launched it no time."""
    if not WIDE_LAUNCHES[design]:
        raise AssertionError(f"lstm {design} design: no launch in phases 13 (c) and 14")
    t = lstm["timings"][shape]
    if t["design"] != design:
        raise AssertionError(f"lstm {shape}: {t['design']} design, not {design}")
    return {
        "name": f"lstm_{design}",
        "route": "cuda",
        "source": "mmtpu_torch/ops/csrc/lstm_wide.cu",
        "replaces": "mmtpu/ops/lstm.py:61",
        "launches": WIDE_LAUNCHES[design],
        "launches_of": "phase 13 (c)'s forwards, phase 14's GCNet two epochs and EFModelAL "
                       "forward",
        "max_abs_err": max(e for k, e in lstm["errors"].items()
                           if lstm["plans"][k].design == design),
        **{key: t[key] for key in ("ms", "plain_ms", "device_ms", "plain_device_ms", "host_ms",
                                   "op_host_ms", "direct_host_ms", "bound_ms", "bound_by",
                                   "cluster", "rows_per_tile", "blocks")},
        "library_ms": t.get("library_ms"),
        "library_device_ms": t.get("library_device_ms"),
        "shape": "G={}, B={}, T={}, H={}, float32; library_ms is G nn.LSTM calls, projection "
                 "included".format(*shape),
    }


# -- the second process: phases 11, 12 (b), (c), 13 and 14 -----------------------------

SIDE_TIMEOUT_S = 1100  # the second process's limit, inside the script's own


def _portable(obj):
    """`obj` with its tensors on the CPU and anything pickle cannot take as
    its repr, for the second process's results file."""
    import pickle

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _portable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_portable(v) for v in obj)
    try:
        pickle.dumps(obj)
    except Exception:  # noqa: BLE001 - a lambda, a module, an open handle: its repr
        return repr(obj)
    return obj


def _side_worker(spec: dict) -> int:
    """The second process (`--side-worker SPEC`): phases 11, 12 (b), (c), 13
    and 14 in their order, under `spec["work"]`, with TF32 off as phases 2
    and 8 leave it for the phases after them in one process; their results,
    the wide designs' launches and each phase's seconds into
    `results.pt` there."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, card, work = torch.device("cuda"), spec["card"], Path(spec["work"])
    t0 = time.perf_counter()
    self_mm = phase_self_mm(dev, card, work)
    mmimdb = phase_mmimdb(dev, card, work)
    t1 = time.perf_counter()
    ks = phase_ks(dev, card, work)
    mono = phase_mono(dev, card, work)
    t2 = time.perf_counter()
    pool = iemocap_pool()
    iemocap = phase_iemocap(dev, card, work, pool)
    chain = phase_mmimdb_chain(dev, card, work,
                               mono["runs"]["mmimdb"]["models"] / "encoder_text_best.pth")
    recurrent = phase_recurrent(dev, pool)
    t3 = time.perf_counter()
    p14 = phase14(dev, card)
    t4 = time.perf_counter()
    torch.save(_portable({
        "self_mm": self_mm, "mmimdb": mmimdb, "ks": ks, "mono": mono, "iemocap": iemocap,
        "chain": chain, "recurrent": recurrent, "p14": p14, "wide": dict(WIDE_LAUNCHES),
        "seconds": {"11": t1 - t0, "12": t2 - t1, "13": t3 - t2, "14": t4 - t3}}),
        work / "results.pt")
    return 0


class SideProcess:
    """`_side_worker` in a process of its own, its output into a file that
    `finish` (or `stop`, on a failure) copies to this one's."""

    def __init__(self, work: Path, card: str):
        self.work = work
        work.mkdir()
        self.log = work / "output.txt"
        self.echoed = False
        self.t0 = time.perf_counter()
        with self.log.open("w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--side-worker",
                 json.dumps({"work": str(work), "card": card})],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)

    def _echo(self) -> None:
        if not self.echoed:
            self.echoed = True
            say("[side] the second process's output (phases 11, 12 (b), (c), 13, 14):")
            sys.stdout.write(self.log.read_text(errors="replace"))
            sys.stdout.flush()

    def finish(self) -> dict:
        """Wait for it; its results, or an AssertionError if it failed."""
        import torch

        try:
            rc = self.proc.wait(timeout=max(1.0, SIDE_TIMEOUT_S - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"[side] the second process ran past {SIDE_TIMEOUT_S} s")
        self._echo()
        if rc != 0:
            raise AssertionError(f"[side] the second process exited with {rc}")
        say(f"[side] ended after {time.perf_counter() - self.t0:.1f} s")
        return torch.load(self.work / "results.pt", weights_only=False)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._echo()


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description="Smoke run of mmtpu_torch on one GPU")
    parser.add_argument("--train-only", action="store_true",
                        help="build the kernels and run the training phases alone (no "
                             "kernels or ok line)")
    parser.add_argument("--reader-only", action="store_true",
                        help="build the kernels, pretrain the audio encoder and run the "
                             "reader phase alone (no kernels or ok line)")
    parser.add_argument("--shipped-only", action="store_true",
                        help="build the kernels, write the reader phase's .pt files and run "
                             "the shipped-weights phase alone (no kernels or ok line)")
    parser.add_argument("--cmam-only", action="store_true",
                        help="build the kernels, write the reader phase's .pt files and "
                             "seeded teachers, and run the C-MAM phase alone (no kernels or "
                             "ok line)")
    parser.add_argument("--msa-only", action="store_true",
                        help="build the kernels, save a seeded UttFusion teacher and run the "
                             "MMIN and RedCore phase alone (no kernels or ok line)")
    parser.add_argument("--self-mm-only", action="store_true",
                        help="build the kernels and run phase 11's Self-MM half alone (no "
                             "kernels or ok line)")
    parser.add_argument("--mmimdb-only", action="store_true",
                        help="build the kernels and run phase 11's MM-IMDb half alone (no "
                             "kernels or ok line)")
    parser.add_argument("--export-only", action="store_true",
                        help="build the kernels, write seeded AVMNIST, UttFusion and teacher "
                             "checkpoints and run phase 12's export part alone (no kernels "
                             "or ok line)")
    parser.add_argument("--ks-only", action="store_true",
                        help="build the kernels and run phase 12's Kinetics-Sounds part "
                             "alone (no kernels or ok line)")
    parser.add_argument("--mono-only", action="store_true",
                        help="build the kernels and run phase 12's monomodal part alone (no "
                             "kernels or ok line)")
    parser.add_argument("--iemocap-only", action="store_true",
                        help="build the kernels and run phase 13's IEMOCAP CV alone (no "
                             "kernels or ok line)")
    parser.add_argument("--mmimdb-chain-only", action="store_true",
                        help="build the kernels and run phase 13's MM-IMDb chain alone, its "
                             "text pretraining included (no kernels or ok line)")
    parser.add_argument("--recurrent-only", action="store_true",
                        help="build the kernels and run phase 13's recurrent encoders alone "
                             "(no kernels or ok line)")
    parser.add_argument("--mult-only", action="store_true",
                        help="build the kernels and run phase 14's MulT alone (no kernels or "
                             "ok line)")
    parser.add_argument("--gcnet-only", action="store_true",
                        help="build the kernels and run phase 14's GCNet alone (no kernels or "
                             "ok line)")
    parser.add_argument("--ef-only", action="store_true",
                        help="build the kernels and run phase 14's EFModelAL alone (no kernels "
                             "or ok line)")
    parser.add_argument("--resident-only", action="store_true",
                        help="build the kernels and run phase 15's device-resident fine-tune "
                             "alone (no kernels or ok line)")
    parser.add_argument("--stacked-only", action="store_true",
                        help="build the kernels and run phase 2's member-axis kernels and "
                             "phase 15's stacked folds and runs alone (no kernels or ok line)")
    parser.add_argument("--mesh-only", action="store_true",
                        help="build the kernels and run phase 16's data-parallel checks, "
                             "(a)-(g), alone (no kernels or ok line)")
    parser.add_argument("--monitor-only", action="store_true",
                        help="build the kernels and run phase 17's monitor checks alone (no "
                             "kernels or ok line)")
    parser.add_argument("--model-axis-only", action="store_true",
                        help="build the kernels and run phase 18's model-axis and UMAP "
                             "checks alone (no kernels or ok line)")
    parser.add_argument("--multihost-only", action="store_true",
                        help="build the kernels and run phase 18 (a), then phase 19's "
                             "mesh of separately started launchers against it (no kernels "
                             "or ok line)")
    parser.add_argument("--axis-worker", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--side-worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    if args.axis_worker is not None:  # one of phase 19's launchers
        return _multihost_worker(json.loads(args.axis_worker))
    if args.side_worker is not None:  # phases 11-14 beside this process's 5-10, 15, 17
        return _side_worker(json.loads(args.side_worker))
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; host "
        f"{_host_cpus()}")

    phase_build()
    cache = ROOT / ".cache"
    cache.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=cache))
    if args.train_only:
        try:
            t0 = time.perf_counter()
            phase_train(dev, smi, work)
            t1 = time.perf_counter()
            phase_train_utt(dev, smi, work)
            say(f"[summary] training phases: AVMNIST {t1 - t0:.1f} s, UttFusion "
                f"{time.perf_counter() - t1:.1f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    if args.reader_only:
        from mmtpu_torch.cli import train_monomodal

        try:
            out_root = work / "train"
            mono_path = work / "train_mono.json"
            mono_path.write_text(json.dumps(train_configs(str(out_root))["mono"]))
            mono = _run_cli(train_monomodal, mono_path, "[train mono]", out_root, MONO_NAME)
            t0 = time.perf_counter()
            phase_train_reader(dev, smi, work, mono["models"] / "encoder_audio_best.pth")
            say(f"[summary] reader phase {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.shipped_only:
        try:
            data = write_avmnist_files(work / "avmnist_data", TRAIN_SAMPLES)
            t0 = time.perf_counter()
            phase_shipped(dev, smi, work, data["csvs"])
            say(f"[summary] shipped-weights phase {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.cmam_only:
        try:
            data = write_avmnist_files(work / "avmnist_data", TRAIN_SAMPLES)
            t0 = time.perf_counter()
            cmam = phase_cmam(dev, smi, work, data["csvs"], cmam_bases(work))
            say_cmam(smi, cmam, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.msa_only:
        try:
            t0 = time.perf_counter()
            msa = phase_msa(dev, smi, work, msa_teacher(work))
            say_msa(smi, msa, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.self_mm_only or args.mmimdb_only:
        try:
            t0 = time.perf_counter()
            self_mm = phase_self_mm(dev, smi, work) if args.self_mm_only else None
            mmimdb = phase_mmimdb(dev, smi, work) if args.mmimdb_only else None
            say_phase11(smi, self_mm, mmimdb, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.export_only or args.ks_only or args.mono_only:
        try:
            t0 = time.perf_counter()
            export = ks = mono = None
            if args.export_only:
                paths = {}
                for key, cfg in (("av", smoke_config(out_root=str(work / "out"))),
                                 ("mosi", mosi_smoke_config(out_root=str(work / "out")))):
                    paths[key] = work / f"{key}.json"
                    paths[key].write_text(json.dumps(cfg))
                phase_predict(dev, work, paths["av"], AVMNIST_PATH)
                phase_predict(dev, work, paths["mosi"], MOSI_PATH)
                best = {key: _checkpoint(path, "best") for key, path in paths.items()}
                export = phase_export(dev, smi, work, paths["av"], best["av"], paths["mosi"],
                                      best["mosi"], msa_teacher(work), None)
            if args.ks_only:
                ks = phase_ks(dev, smi, work)
            if args.mono_only:
                mono = phase_mono(dev, smi, work)
            say_phase12(smi, export, ks, mono, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.iemocap_only or args.mmimdb_chain_only or args.recurrent_only:
        try:
            t0 = time.perf_counter()
            pool = iemocap_pool() if args.iemocap_only or args.recurrent_only else None
            iemocap = phase_iemocap(dev, smi, work, pool) if args.iemocap_only else None
            chain = phase_mmimdb_chain(dev, smi, work) if args.mmimdb_chain_only else None
            recurrent = phase_recurrent(dev, pool) if args.recurrent_only else None
            say_phase13(smi, iemocap, chain, recurrent, time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.mult_only or args.gcnet_only or args.ef_only:
        t0 = time.perf_counter()
        p14 = phase14(dev, smi, args.mult_only, args.gcnet_only, args.ef_only)
        say_phase14(smi, p14["mult"], p14["gcnet"], p14["ef"], time.perf_counter() - t0)
        shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.resident_only or args.stacked_only:
        try:
            t0 = time.perf_counter()
            if args.stacked_only:
                phase_kernels_members(dev)
            p15 = phase15(dev, smi, work, args.resident_only, args.stacked_only)
            say_phase15(smi, p15["resident"], p15["folds"], p15["runs"],
                        time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.mesh_only:
        try:
            t0 = time.perf_counter()
            say_phase16(smi, phase16(dev, smi, work), time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.monitor_only:
        try:
            t0 = time.perf_counter()
            say_phase17(smi, phase17(dev, smi, work), time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.model_axis_only:
        try:
            t0 = time.perf_counter()
            say_phase18(smi, phase18(dev, smi, work), time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    if args.multihost_only:
        try:
            phase_model_axis(dev, smi, work)
            t0 = time.perf_counter()
            say_phase19(smi, phase19(dev, smi, work), time.perf_counter() - t0)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

    t_2 = time.perf_counter()
    mlp = phase_kernels_mlp(dev)
    t_lstm = time.perf_counter()
    lstm = phase_kernels_lstm(dev)
    t_members = time.perf_counter()
    members = phase_kernels_members(dev)
    t_3 = time.perf_counter()
    say(f"[summary] phase 2 {t_3 - t_2:.1f} s: fused_mlp {t_lstm - t_2:.1f} s, lstm "
        f"{t_members - t_lstm:.1f} s, member axis {t_3 - t_members:.1f} s")
    for kern, rows in ((mlp, members["mlp"]), (lstm, members["lstm"])):
        kern["max_err"] = max(kern["max_err"], *(t["max_abs_err"] for t in rows.values()))
    side = None
    try:
        av_cfg = work / "avmnist.json"
        av_cfg.write_text(json.dumps(smoke_config(out_root=str(work / "out"))))
        av_pred = phase_predict(dev, work, av_cfg, AVMNIST_PATH)
        av_srv = phase_serve(av_cfg, AVMNIST_PATH, avmnist_requests())
        mosi_cfg = work / "mosi.json"
        mosi_cfg.write_text(json.dumps(mosi_smoke_config(out_root=str(work / "out"))))
        mosi_pred = phase_predict(dev, work, mosi_cfg, MOSI_PATH)
        mosi_srv = phase_serve(mosi_cfg, MOSI_PATH, mosi_requests())
        t_train = time.perf_counter()
        say(f"[summary] phases 3-4 (predict, serve) {t_train - t_3:.1f} s")
        side = SideProcess(work / "side", smi)  # phases 11, 12 (b), (c), 13, 14
        train = phase_train(dev, smi, work)
        t_utt = time.perf_counter()
        utt = phase_train_utt(dev, smi, work)
        t_reader = time.perf_counter()
        reader = phase_train_reader(dev, smi, work, train["handoff"])
        t_shipped = time.perf_counter()
        shipped = phase_shipped(dev, smi, work, reader["csvs"])
        t_cmam = time.perf_counter()
        cmam = phase_cmam(dev, smi, work, reader["csvs"],
                          {"cmam": train["scratch"]["models"] / "best.pth",
                           "dual": utt["run"]["models"] / "best.pth"})
        t_msa = time.perf_counter()
        msa = phase_msa(dev, smi, work, utt["run"]["models"] / "best.pth")
        t_12 = time.perf_counter()
        export = phase_export(dev, smi, work, av_cfg, train["scratch"]["models"] / "best.pth",
                              mosi_cfg, utt["run"]["models"] / "best.pth",
                              utt["run"]["models"] / "best.pth", av_srv["requests_per_s"])
        t_15 = time.perf_counter()
        p15 = phase15(dev, smi, work)
        t_17 = time.perf_counter()
        p17 = phase17(dev, smi, work)
        t_side = time.perf_counter()
        got = side.finish()
        t_16 = time.perf_counter()
        say(f"[summary] phases 5-10, 12 (a), 15 and 17 {t_side - t_train:.1f} s beside phases "
            f"11, 12 (b), (c), 13 and 14 in the second process "
            f"{sum(got['seconds'].values()):.1f} s; {t_16 - t_side:.1f} s waited for it")
        self_mm, mmimdb, ks, mono, iemocap, chain, recurrent, p14 = (
            got[k] for k in ("self_mm", "mmimdb", "ks", "mono", "iemocap", "chain",
                             "recurrent", "p14"))
        for design, n in got["wide"].items():
            WIDE_LAUNCHES[design] += n
        p16 = phase16(dev, smi, work)
        t_18 = time.perf_counter()
        p18 = phase18(dev, smi, work)
        t_19 = time.perf_counter()
        p19 = phase19(dev, smi, work)  # in turn, after 18 (a), whose files it reads
        side_s = got["seconds"]
        (t_train, t_utt, t_reader, t_shipped, t_cmam, t_msa, t_11, t_12, t_13, t_14, t_15,
         t_16, t_17, t_18, t_19) = (
            t_utt - t_train, t_reader - t_utt, t_shipped - t_reader, t_cmam - t_shipped,
            t_msa - t_cmam, t_12 - t_msa, side_s["11"], t_15 - t_12 + side_s["12"],
            side_s["13"], side_s["14"], t_17 - t_15, t_18 - t_16, t_side - t_17, t_19 - t_18,
            time.perf_counter() - t_19)
    finally:
        if side is not None:
            side.stop()
        shutil.rmtree(work, ignore_errors=True)

    for label, pred, srv in (("AVMNIST", av_pred, av_srv), ("UttFusion", mosi_pred, mosi_srv)):
        say(f"[summary] {label}: predict {pred['steady_visits_per_s']:.1f} visits/s steady; "
            f"serve {srv['requests_per_s']:.1f} requests/s (no-model ceiling "
            f"{srv['null_requests_per_s']:.1f})")
    say_card(smi, f"[summary] training: mono {train['mono']['samples_per_s']:.1f}, pretrained "
          f"fine-tune {train['pretrained']['samples_per_s']:.1f}, scratch "
          f"{train['scratch']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}); "
          f"busy share {train['profile']['busy_share']:.3f}; phase {t_train:.1f} s")
    say_card(smi, f"[summary] UttFusion training: {utt['run']['samples_per_s']:.1f} train "
             f"samples/s (epoch {TRAIN_EPOCHS}); {utt['profile']['kernels_per_step']:.1f} device "
             f"kernels per train step, busy share {utt['profile']['busy_share']:.3f}; lstm "
             f"launches {utt['launches']}; peak {utt['run']['peak_bytes'] / 2**20:.1f} MiB; "
             f"phase {t_utt:.1f} s")
    say_card(smi, f"[summary] reader: {reader['build']['samples']} samples from the files "
             f"{reader['build']['files_s']:.3f} s, from the sidecars "
             f"{reader['build']['sidecars_s']:.3f} s; reader-fed fine-tune "
             f"{reader['run']['samples_per_s']:.1f} train samples/s (epoch {TRAIN_EPOCHS}, "
             f"under --profile); fused_mlp launches fine-tune {reader['launches']}, cv "
             f"{reader['cv_launches']}, sweep {reader['sweep_launches']}; cv {reader['cv_s']:.1f} "
             f"s, sweep {reader['sweep_s']:.1f} s; phase {t_reader:.1f} s")
    say_card(smi, "[summary] shipped weights: " + ", ".join(
        f"{key} {run['samples_per_s']:.1f}" for key, run in shipped["runs"].items())
        + f" train samples/s (epoch {TRAIN_EPOCHS}); fused_mlp launches "
        f"{shipped['launches']}; busy share {shipped['profile']['busy_share']:.3f}; replay "
        f"{shipped['load']['replay_err']:.3e}, predict GPU vs CPU "
        f"{shipped['predict_err']:.3e}; phase {t_shipped:.1f} s")
    say_cmam(smi, cmam, t_cmam)
    say_msa(smi, msa, t_msa)
    say_phase11(smi, self_mm, mmimdb, t_11)
    say_phase12(smi, export, ks, mono, t_12)
    say_phase13(smi, iemocap, chain, recurrent, t_13)
    say_phase14(smi, p14["mult"], p14["gcnet"], p14["ef"], t_14)
    say_phase15(smi, p15["resident"], p15["folds"], p15["runs"], t_15)
    say_phase16(smi, p16, t_16)
    say_phase17(smi, p17, t_17)
    say_phase18(smi, p18, t_18)
    say_phase19(smi, p19, t_19)
    mlp["max_err"] = max(mlp["max_err"], p18["axis"]["shard_err"], p19["shard_err"],
                         *(t["max_abs_err"] for t in p18["axis"]["shapes"].values()))
    say(f"[summary] fused_mlp B=1024 {json.dumps(mlp['timings'][1024])}")
    for batch, t in mlp["mesh"].items():
        say_card(smi, f"[summary] fused_mlp {HEAD_DIMS} B={batch} (a rank's shard) "
                 f"{json.dumps(t)}")
    for batch, t in mlp["shipped"].items():
        say(f"[summary] fused_mlp {SHIPPED_HEAD_DIMS} B={batch} {json.dumps(t)}")
    say(f"[summary] fused_mlp {SHIPPED_HEAD_DIMS} max |kernel - plain| "
        f"{mlp['shipped_err']:.3e} at B=128 and 1024 (tolerance {KERNEL_TOL})")
    for shape, t in lstm["timings"].items():
        say_card(smi, f"[summary] lstm G,B,T,H={shape} {json.dumps(t)}")
    say(f"[summary] {time.perf_counter() - t_start:.1f} s in all")
    G, B, T, H = LSTM_MAIN
    print(json.dumps({"kernels": [
        {**kernel_record("fused_mlp", "mmtpu_torch/ops/csrc/fused_mlp.cu",
                         "mmtpu/ops/fused_mlp.py:63", "B=128, 192-128-64-10, float32",
                         mlp, mlp["timings"][128], av_pred, av_srv),
         "train_launches": train["launches"], "reader_launches": reader["launches"],
         "cv_launches": reader["cv_launches"], "sweep_launches": reader["sweep_launches"],
         "shipped_launches": shipped["launches"],
         "msa_launches": {kind: r["launches"]["fused_mlp"] for kind, r in msa.items()},
         "self_mm_launches": {kind: r["launches"]["fused_mlp"] for kind, r in self_mm.items()},
         "mmimdb_launches": mmimdb["launches"]["fused_mlp"],
         "artifact_launches": export["avmnist"]["launches"],
         "ks_launches": ks["launches"]["fused_mlp"],
         "iemocap_launches": iemocap["launches"]["fused_mlp"],
         "mmimdb_chain_launches": chain["launches"]["fused_mlp"],
         "phase14_launches": {
             **{f"mult_{kind}": r["launches"]["fused_mlp"] for kind, r in p14["mult"].items()},
             "gcnet": p14["gcnet"]["launches"]["fused_mlp"]},
         "shipped_head": {"dims": SHIPPED_HEAD_DIMS, "max_abs_err": mlp["shipped_err"],
                          **{f"B={b}": t for b, t in mlp["shipped"].items()}},
         "member_axis": {f"K={k}, B={b}": t for (k, b), t in members["mlp"].items()},
         "phase15_launches": {
             "resident_fine_tune": p15["resident"]["launches"]["on"]["fused_mlp"],
             "streaming_fine_tune": p15["resident"]["launches"]["off"]["fused_mlp"],
             **{f"folds_{k}": r["launches"]["fused_mlp"]
                for k, r in p15["folds"]["runs"].items()}},
         "phase16_launches_per_rank": p16["avmnist"]["launches"]["fused_mlp"],
         "phase17_launches": {"check_3_steps": p17["avmnist"]["check"]["launches"]["fused_mlp"],
                              **{f"epoch_{k}": r["fused_mlp"] for k, r in
                                 p17["avmnist"]["cost"]["launches"].items()}},
         "mesh_shapes": {f"B={b}": t for b, t in mlp["mesh"].items()},
         "phase18_launches_per_eval_step_per_rank": p18["axis"]["launches_per_eval_step"],
         "phase19_launches_per_eval_step_per_rank": p19["launches_per_eval_step"],
         "model_axis_shapes": p18["axis"]["shapes"]},
        {**kernel_record("lstm", "mmtpu_torch/ops/csrc/lstm.cu", "mmtpu/ops/lstm.py:61",
                         f"G={G}, B={B}, T={T}, H={H}, float32; library_ms is {G} nn.LSTM "
                         "calls, projection included (with_projection_ms is ours with it)",
                         lstm, lstm["timings"][LSTM_MAIN], mosi_pred, mosi_srv),
         "train_launches": utt["launches"],
         "mmin_launches": msa["mmin"]["launches"]["lstm"],
         "self_mm_launches": {kind: r["launches"]["lstm"] for kind, r in self_mm.items()},
         "mmimdb_launches": mmimdb["launches"]["lstm"],
         "artifact_launches": export["utt"]["launches"],
         "dual_cmam_artifact_launches": export["dual"]["launches"],
         "mono_lstm_launches": mono["launches"]["audio"]["lstm"],
         "ks_launches": ks["launches"]["lstm"],
         "iemocap_launches": iemocap["launches"]["lstm"],
         "mmimdb_chain_launches": chain["launches"]["lstm"],
         "recurrent_launches": {k: r["launches"] for k, r in recurrent.items()},
         "phase14_launches": {
             **{f"mult_{kind}": r["launches"]["lstm"] for kind, r in p14["mult"].items()},
             "gcnet_train_two_epochs": p14["gcnet"]["launches"]["lstm"],
             "gcnet_per_forward": {base: c["launches"]
                                   for base, c in p14["gcnet"]["checks"].items()},
             "ef_per_forward": p14["ef"]["launches"]},
         "member_axis": {"K={}, G={}, B={}, T={}, H={}".format(*k): t
                         for k, t in members["lstm"].items()},
         "phase15_launches": {f"stacked_runs_{k}": r["launches"]["lstm"]
                              for k, r in p15["runs"]["stacked"].items()}
         | {"sequential_member": p15["runs"]["seq_launches"]},
         "phase16_launches_per_rank": p16["utt"]["launches"]["lstm"],
         "phase16_driver_launches_per_rank": {
             kind: r["launches"]["lstm"] for kind, r in p16["drivers"].items()
             if "launches" in r},
         "phase17_launches": {"check_3_steps": p17["utt"]["check"]["launches"]["lstm"],
                              **{f"epoch_{k}": r["lstm"] for k, r in
                                 p17["utt"]["cost"]["launches"].items()}},
         "wide_shapes": {"G={}, B={}, T={}, H={}".format(*k): lstm["timings"][k]
                         for k in WIDE_LSTM},
         "mesh_shapes": {"G={}, B={}, T={}, H={}".format(*k):
                         {**lstm["timings"].get(k, {}), "max_abs_err": lstm["errors"][k]}
                         for k in MESH_LSTM},
         "with_projection_ms": lstm["timings"][LSTM_MAIN]["with_projection_ms"],
         "grad_max_abs_err": lstm["grad_err"],
         "serial_steps": T,
         "design": "narrow (csrc/lstm.cu, H <= 100): the main path's H = 64",
         "crossover": {"G={}, B={}, T={}, H={}".format(*k): v
                       for k, v in lstm["crossover"].items()}},
        *[wide_record(design, lstm, shape) for design, shape in WIDE_RECORD_SHAPES.items()],
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
