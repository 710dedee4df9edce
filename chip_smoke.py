#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (edgedict_tpu_torch) on one GPU.

  python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing JSON or text lines:
  1 device   card name, nvidia-smi name + power limit
  2 build    nvcc build of csrc/*.cu (seconds, ptxas register/spill lines)
  3 kernels  K1 (LSTM forward), K2 (mel power), K3 (greedy frame loop),
             K4 (LSTM backward), K5 (GRU forward), K6 (GRU backward), K7/K8
             (fused joint forward / backward), K9/K10 (lattice alpha /
             beta+grad), K11 (int8-weight matmul), K12/K13 (int8 LSTM / GRU
             recurrences), each against its plain PyTorch version on the
             card at the main paths' shapes, with stated tolerances (tokens
             exact), and both timed with CUDA events (median of 20 after
             warm-up, in turns plain, kernel, kernel, plain); K11 also
             beside a dequantize-then-F.linear yardstick (its tiled
             kernels, R > 32, as the quant_matmul_tile entry with every R=512
             case), the recurrences
             K1/K4/K5/K6 beside one cuDNN nn.LSTM / nn.GRU layer (forward,
             or forward+backward) and the port's own layer timed the same
             way (library_ms, layer_ms); K1 also at the beam search's
             steps (T=1: H=256 B=4, 16 and 32, H=512 B=4 fp32 and bf16 and
             B=32 fp32, the rows of slice_beam, train_run's beam eval and
             server_beam; the B=4 ones beside a cuDNN layer, with device
             ms) and lm_train's H=512 B=32 T=64 (K4 too), the K1 ones
             bit-stable, all after every other case on their own seed;
             K4/K6 also split into their two launches, the gate remat
             and the dh chain (torch.profiler
             device ms), and K8 into its tensor-core launches (h, dlogits,
             dh, dW, the partials' reduction) with its launch plan; K1 and
             K5 (one persistent launch per call) with their launch plan
             (grid, shared memory, blocks per SM), also at the training
             shape (H=1024 B=32 T=427 bf16, held step by step from the
             kernel's own state) beside cuDNN's layer forward and the port's
             own layer; K12/K13 beside dequantize + one cuDNN layer
             forward and the port's own int8 layer, K12 and K13 (K1's / K5's
             persistent launch with an int8 prologue) at B=1 and B=64 T=2
             and B=1 T=16 in both dtypes, K13 also at H=72 (the scalar
             prologue), each bit-stable, with its plan, its device ms and
             the profiler's kernel records per call; K9 and K10 (one
             register-wavefront launch each, one plan,
             ops/rnnt_loss_kernel.py beta_plan), K9 against its plain
             version in fp64 (alpha on the cells t <= xlen, u <= ylen;
             logZ = alpha[xlen, ylen] bit for bit; no memory past its
             outputs), K10 against its plain version given the same alpha
             and logZ, at the E6D2 step (timed, with device ms) and at U+1
             = 1, 7, 300, 1100, 2100, T=1 and xlen=0, each bit-stable, one
             kernel record per call, and the K9 -> K10 chain against the
             plain chain in fp64; K2 (one launch, plan
             ops/features_plan.py) at the chunk for 1, 8 and 64 streams,
             4 s, the train step's 32 x 16 s, the shortest legal row and
             one off the hop grid, each bit-stable, with its plan and, at
             the chunk and the train step, its device ms; K7 (bf16: two lattice
             tiles a block, h resident in shared memory, plan
             ops/joint_lse_plan.py fwd_plan) at the E6D2 step also with h
             staged through the slab scratch (both timed, the same bits),
             at ragged B=33, U+1 = 1, 300, 1100, J/V padded (600, 2000), a
             wide J=768 and fp32, each bit-stable across two calls; K7 in
             fp32 (FFMA tiles) at the evals' B=32 T=214 U+1=65 and B=4
             T=1437 U+1=33 and K8 in fp32 at B=32 T=214 U+1=65 (an E6D2
             --bf16 false step), each timed beside the plain joint over the
             whole lattice and its bound, to 1e-4; K3 (one
             cooperative launch over the card, plan ops/decode_plan.py) at
             B=1/8 T=1/16, the int8 server's B=64 and the eval decode's B=4
             T=214, bit-stable, with its device time by torch.profiler;
             then, on their own seed after every other case, a 16 s raw
             fine-tune step at E6D2's U+1 = 65 (wav2vec_kernels; the
             wav2vec runs' own shapes, timed, are phase 19's), checked and
             not timed: K1 bf16 held step by step and K4 at B=32 T=1597,
             K9/K10 and K7/K8 at B=32 T=1597 U+1=65 (the joint against the
             plain joint by time chunks); then one library call beside the
             shapes that had none (library_rows); a plain version over 20
             ms a call (LONG_PLAIN_MS) is timed once before and once after
             the kernel; the
             inputs of over 2^24 elements are drawn on the card;
             each kernel's bound
             (bytes once over 3.35 TB/s, or operations over the peak of
             their type, whichever is larger) from the timed inputs
  4 slice    E6D2 from flagfiles/E6D2.txt with seeded random weights:
             StreamingDecoder.decode_wav of 4 s of seeded synthetic audio
             on cuda fp32 == the CPU run (plain versions), token for token;
             cuda bf16 encoder diff and token agreement; per-chunk ms
  5 slice_int8  the same decode with quantize='int8' (fp32): cuda == the
             CPU int8 run token for token, int8-vs-fp32 token agreement,
             per-chunk ms, encoder bytes int8 against fp32
  6 slice_gru  E6D2 widths with enc_type GRU (seeded random weights): cuda
             fp32 == CPU, cuda int8 == CPU int8, bf16 encoder diff and
             token agreement, per-chunk ms
  7 server   StreamServer over MultiStreamDecoder(n_streams=8, cuda), as
             edgedict_tpu_torch/cli/serve.py builds it; 4 concurrent
             clients, each transcript == decode_wav of its audio
  8 server_int8  the same with quantize='int8' (cli/serve.py --quantize
             int8) at n_streams=64, where every K11 call runs its tiled
             kernel (R = 128 and 64 rows)
  9 train_parity  one fp32 E6D2 train step (full width and depth, B=4,
             ~2 s) on cuda against the CPU plain path from the same weights
             and batch: loss, grad_norm, grads and params after the Adam step
 10 train_parity_gru  the same with --enc_type GRU (K5/K6 on cuda)
 11 train_run  the port's Trainer (as cli/baseline.py builds it) from
             flagfiles/E6D2.txt (batch 32, bf16, BPE 2048) on a seeded
             synthetic corpus of 8-16 s utterances: 2 warm-up and 5 measured
             steps (median step ms, audio s/s, peak memory), loss falling on
             a repeated small batch, one --mode eval pass (val_loss, WER;
             its launches counted), then its greedy eval steps timed again
             (wall ms a batch, kernels' device ms a batch)
 12 train_run_gru  the same with --enc_type GRU on the same corpus and
             BPE model, plus one step of a Trainer with --time_warp_w 80
             --optim novograd (finite loss); the LSTM run's eval pass also
             has --eval_beam_width 4 and must print a finite beam_WER
 13 lm_train cli.train_lm at LMConfig's defaults (V=2048, 256 / 512 / 2
             layers) on that corpus's texts with its BPE 2048, at E6D2's
             batch 32, ~20 steps: finite, falling loss, lm.ckpt written
 14 slice_beam  StreamingBeamDecoder.decode_wav (E6D2, W=4, 3 expansions a
             frame, prefix merging, 200 tokens; seeded weights made peaky,
             see _beam_models) of 2 s of seeded audio without LM, with a
             seeded LM (weight 0.2) and with quantize='int8': cuda best
             tokens ==
             the CPU run's, best logp within rel 1e-4, non-empty; bf16
             agreement, the smallest prune gap (of the warm-up decode),
             per-chunk wall ms, profiled
             device ms and busy share; then cli.stream --beam_width 4
             --lm_path <lm_train's lm.ckpt> == decode_wav with that LM
 15 server_beam  StreamServer over MultiStreamBeamDecoder(n_streams=8,
             W=4, the LM) as cli/serve.py --beam_width 4 builds it ('='
             messages); 4 clients, each final transcript == decode_wav;
             the same rounds driven directly under the profiler (device
             ms and busy share a round)
 16 pretrain_parity  one fp32 step of the full-width wav2vec model (E6D2's
             encoder, input 128, pretrain_config's defaults) through
             Wav2VecPretrainer.run_step at batch 8 x 48,000 samples on
             cuda against the CPU plain path: the same weights, crops,
             masks and injected draws, the pretrainer's lr and temperature
             at host step 1; loss, grad_norm, grads and the params after
             the AdamW-without-LN-decay step
 17 pretrain_run  the pretrainer as cli.pretrain_wav2vec builds it
             (batch 32 x 48,000 samples, fp32) on the train_run corpus:
             measured steps (step ms, audio s/s, busy share, peak
             memory), then cli.pretrain_wav2vec for one epoch: finite
             losses, accuracies in [0, 1], pretrained.ckpt written
 18 raw_train_run  cli.train --flagfile flagfiles/E6D2.txt --use_pretrained
             as it builds the RawTrainer (batch 32, bf16, 8-16 s, T up to
             1601): the spliced FrontEnd and encoder equal pretrained.ckpt
             bit for bit, measured steps, loss falling on a repeated
             batch, then cli.train --mode eval reloads the run and prints
             a finite val_loss and WER; the eval timed whole (wall and
             device ms a batch, each kernel's device ms)
 19 wav2vec_kernels  each kernel of phases 17 and 18 against its plain
             version at the shapes those runs gave it (their micro-batch
             and eval-batch B, frames and U+1, the lattice at their own
             xlen / ylen): pretraining's K1 / K4 fp32 and its eval's K1;
             the fine-tune's encoder K1 / K4 bf16 (K1 held step by step),
             prediction-net K1 / K4 fp32, K7-K10 bf16; its eval's K1 fp32
             (encoder, prediction net, the decode's T=1 priming), K7 fp32,
             K9 and K3, each timed with its bound
 20 train_features  the trainer's one-card features at E6D2 width (the
             train_run corpus, batch 32, bf16): --device_corpus (its GB on
             the card, the host loader's index order over two epochs, a
             gathered batch against the host collation of its utterances);
             turns of 5 steps, P D S S D P (P: the host loader's
             page-locked batches copied one ahead on a side stream; D: the
             device corpus; S: run_step's blocking copy), each turn timed
             from its first batch to a synchronise after its last step,
             with the busy share of 3 more steps and each mode's peak
             memory; --profile_dir over 14 steps of Trainer.train (the
             chrome trace must hold K1, K2, K4 and K7-K10 records; their
             counts are printed); the background save of the full state
             (~610 MB with Adam): blocking ms against a synchronous save,
             the file equal to the state at the save bit for bit after
             wait_for_checkpoints, the step taken meanwhile not in it
 21 jax_checkpoint  the JAX package's run in tests/data/jax_ckpt/
             (flax-msgpack 2.ckpt with Adam state, its flag snapshot, char
             tokenizer): cli.stream --device cuda --infer_dtype fp32 on it
             emits the JAX package's token at every frame of utt.wav and
             prints its transcript; cli.baseline --mode resume --device
             cuda takes step 3 from it (finite loss, optimizer count 3);
             both runs record the shape of every kernel call they make
 22 jax_kernels  each kernel those two runs launched (K1, K2, K3, K4,
             K7-K10) against its plain version at the recorded shapes (the
             fixture's H=16, J=16, V=22), after checking that the
             recording saw every launch
 23 export  export_transducer (edgedict_tpu_torch/export.py) of the slice's
             E6D2 model on cuda, fp32 and int8, its parity checks passing;
             the ExportedStreamDecoder over the slice's 4 s == the live
             StreamingDecoder on cuda (fp32: text for text with the stand-in
             tokenizer; int8: against live int8), its measured decode's
             launches exactly what its chunks and emitting frames imply (K2
             a chunk; K1 per encoder layer, or K11 per layer and for the
             projection and K12 per layer; the prediction net's K1 per layer
             for the reset's BOS and every non-blank frame; no K3); every
             edgedict op node of the three graphs against its plain
             version on card tensors of the node's shapes; artifact bytes
             (int8 encoder under 0.55x the fp32 one), exported and live
             chunk ms, the host µs of one op dispatch beside a direct call
             of K1's implementation
 24 apps     cli.wer_parity at E6D2 (the slice's weights saved as a
             reference-layout .pt; train_run's eval corpus and BPE 2048;
             --max_batches 1, eval batch 4) on cuda == on the CPU,
             hypothesis for hypothesis, its launches one eval batch's;
             cli.export of the .pt, then cli.wav_inference --backends
             jit,exported,int8 --per_stage on 4 utterances (jit == exported;
             K1, K2, K3, K11, K12 launched) and cli.youtube_live --wav
             ('[jit]' == '[exported]')
 25 ctc      the CTC model (models/ctc.py) at the JAX defaults (4 x 600
             LSTM, projection 600, a time reduction after layer 1; input
             240, E6D2's 80 log-mels stacked 3 times from the port's
             pipeline on the card; V=2048) at batch 32 of 8-16 s: one fp32
             loss + gradient on cuda against the CPU port on the same
             weights and batch, one item's labels longer than its frames
             allow (the optax recursion's finite loss; each utterance's
             loss 1e-5 rel, each grad 1e-3 of its max); greedy decode
             tokens == the CPU's; one warm-up and 5 measured bf16 Adam steps (optim.py; step
             ms, audio s/s, the loss falling)
 26 legacy   the legacy v1 family (models/legacy.py) at width 600 against
             the CPU port: legacy_mfcc with CMVN per utterance (stacked 3
             into input 120), the legacy transducer (encoder 4 x 600 with
             its 600 head, prediction net 1 x 600, embedding 16, V=73) at
             batch 8 of 8-16 s (loss + gradients through K1/K4 and K9/K10;
             greedy decode tokens exact, K1 at T=1 a frame), RNNModel
             (4 x 600) with the CTC prefix beam search of two utterances
             (labels exact), the spline time warp (W=80) of ctc's (32, T,
             80) log-mels on the card against the CPU's on the same draws
 27 legacy_kernels  each K1 / K4 / K9 / K10 shape that phases 25 and 26
             launched (recorded by _recorded_shapes, the spies first held
             against the launch counts) against its plain version with the
             E6D2 cases' tolerances: K1 fp32 and bf16 (held step by step),
             K4, at H=600 (T=422, 211, the prediction net's U+1 and the
             greedy decode's T=1), each beside one cuDNN layer at each
             input width its layers had (recorded with the shapes),
             K9 / K10 at the legacy lattice
 28 surface  the JAX-free featurizers (Queue 1 item 13b) on the card:
             NvidiaFilterbankFeatures and SpectrogramFeatures (plain
             torch.fft) at B=4 x 16 s, 64 filters, fp32, against the CPU
             (max abs 1e-3 / 2e-2 on log features); build_transform's test
             pipeline at E6D2's features (K2, one launch) against plain
 29 dp_train (a) two ranks spawned on cuda:0 over gloo run the shared fp32
             train step at full-width E6D2, 8 rows a rank, 3 Adam steps:
             both ranks' parameters bit-equal, and equal to one process
             over the 16 rows with accum_steps=2 (rtol 1e-4 / atol 1e-5),
             the losses too; (b) python -m torch.distributed.run
             --standalone --nproc_per_node 1 -m
             edgedict_tpu_torch.cli.distributed (NCCL) on train_run's
             corpus: 3 steps, one eval, rank 0's checkpoint loads
 30 server_dp  MultiStreamDecoder and MultiStreamBeamDecoder (W=4) at E6D2,
             fp32 and int8, 8 streams over devices=[cuda:0, cuda:0] (two
             replicas) against one device: tokens bit-equal, round ms of
             both; cli.serve --serve_dp_size 2 exits 2 on one card
 31 pp_train  pipeline parallelism (parallel/pipeline.py) at full-width
             E6D2 on make_layout(pp=2, devices=[cuda:0] * 2), batch 32 of
             2-4 s as accum 2 x 16: one fp32 Adam step of
             make_train_step_pp == the plain step with accum_steps = 2
             (loss rel 1e-5, params rtol 1e-4 / atol 1e-5); 3 bf16 Adam
             steps at pp = 4 (accum 4) lower the loss on the repeated
             batch; step ms and peak memory of each
 32 tp_train  tensor parallelism (parallel/vocab.py): K7 and K8 on each
             vocabulary slice (B=32, T=214, U+1=65, J=640, V/2=1024 and
             the sentinel column; bf16 and fp32) against the slice's plain
             K7 / K8, K8 given the whole vocabulary's lse (slice 0 timed in
             bf16, with its bound); one fp32 Adam step at tp = 2 on
             make_layout(tp=2, devices=[cuda:0] * 2) == the tp = 1 step
             (loss and grad norm rel 1e-5, params train_parity's bounds);
             step ms and peak memory.  Every slot of
             both grids is cuda:0: these phases measure no scaling
 33 large_slice  flagfiles/E6D2_LARGE_Batch.txt (6 x 1024 encoder, 2 x
             512 prediction net, projection 640, hop 320: 120 ms chunks;
             seeded random weights): StreamingDecoder.decode_wav of the
             slice's 4 s, cuda fp32 == the CPU run token for token, bf16
             agreement, per-chunk ms, K3's plan at B=1
 34 large_server  StreamServer over MultiStreamDecoder at that preset, 8
             and 64 streams (cli/serve.py's build); 4 clients of 3 s, each
             transcript == its single-stream CPU decode_wav; the shape
             spies show every K3 launch at B = the streams
 35 large_kernels  K3 at that preset's widths against its plain version
             (k3_check) at B=1, 4, 64, 256 T=1 and the eval's B=4 T=214,
             each with its plan, device ms and bound
 36 large_train_run  the Trainer from that flagfile (batch 128 as 32
             micro-batches of 4, --dec_dropout 0.1, bf16, BPE 2048) on 128
             synthetic utterances of 8-14 s: 2 warm-up and 3 measured steps
             (step ms, audio s/s, peak memory, busy share of one more),
             loss falling on a repeated batch of 4, one --mode eval pass
             (every K3 launch at B=4, the shape spies)
 37 e4d1     flagfiles/E4D1.txt (4 x 256 encoder, hop 160): its
             StreamingDecoder cuda fp32 == CPU; its Trainer (batch 32 as 2
             x 16) 2 steps on the train_run corpus, the loss falling on a
             repeated batch of 16; one --mode eval pass (every K3 launch
             at B=2)
 38 preset_kernels  each kernel shape that the train steps and evals of
             phases 36 and 37 launched (recorded by _recorded_shapes, the
             spies first held against the launch counts) against its plain
             version as in jax_kernels: K1 bf16 held step by step at the
             encoders' and prediction nets' H (1024, 512; 256), K4, K2
             through each preset's mel tables, K3 on each eval's own first
             call (LARGE B=4, E4D1 B=2), K7 / K8 at J=640 / 256, V=2048,
             K9 / K10 at the runs' own lengths
 39 defaults_slice  the flags' defaults, no flagfile (MFCC of 80 over 128
             mels, n_fft 400, hop 200; 4 x 600 LSTM encoder, 2 x 150
             prediction net, joint 512; seeded random weights) at the
             character vocabulary of the 8-14 s corpus (31):
             StreamingDecoder.decode_wav of the slice's 4 s in 75 ms chunks
             of 1,400 samples, cuda fp32 == the CPU run token for token,
             bf16 agreement, per-chunk ms, K2's plan at the chunk, K3's at
             B=1; the measured decode's kernel shapes recorded
 40 defaults_server  StreamServer over MultiStreamDecoder at the defaults,
             8 and 64 streams, as large_server
 41 defaults_train_run  the Trainer at the defaults (batch 8 as one
             micro-batch, bf16, char tokenizer, their dither and
             SpecAugment) on the 8-14 s corpus: one warm-up and 2
             measured steps (finite losses), the loss falling on a
             repeated batch of 8, one --mode eval pass (K3 at B=4); the
             kernel shapes of the steps and the eval recorded
 42 defaults_kernels  each kernel shape of phases 39 and 41 against its
             plain version as in preset_kernels (K2 at n_fft 400 in both
             splits, K1 / K4 at H=600 and 150, K3 at J=512 and V=31, K7 /
             K8 bf16 at J=512, K9 / K10 at the character labels); then K2
             with its device ms at a chunk and at 8 x 14 s, n_fft 400
             beside E6D2's 512
 43 server_int8_gru  cli/serve.py --quantize int8 --enc_type GRU at 64
             streams (E6D2 widths): 4 clients of 3 s, each transcript ==
             its own single-stream CPU int8 decode_wav
 44 synth_convergence  the port's synthetic-language learning run
             (edgedict_tpu_torch/scripts/synthetic_convergence.py: tone
             words, 3 x 128 encoder, 1 x 64 prediction net, joint 128, 40
             log-mels at n_fft 400, hop 160, batch 16, bf16, seeded random
             init, 256 training and 48 held-out utterances) through its
             run() on cuda, four trainings: (a) LSTM, 400 steps, its serving
             A/B (fp32 / bf16 / int8 held-out greedy WER), (b) the same
             with the GRU encoder, (c) the confusable language, noise 0.06,
             600 steps, 64 held out, beam W=4 without and with a trained LM
             at fusion 0.8, (d) the hard language with the SNR sweep inf,
             20, 10, 5, 0; each prints its WERs, losses, median step wall
             ms and seconds; greedy WER under 0.3 (a, b) and 0.35 (c), the
             beam at most 0.02 over greedy (c), and (c)'s card-trained
             transducer and LM decoded again by the CPU's beam on the
             card's features: its 64 hypotheses of each pass == the card's;
             (c)'s LM trained again on the card and on the CPU side by side
             from its initial weights: the first 10 steps from the card's
             parameters within loss rel 1e-5 and gradients 1e-3 of their
             max (gated), the losses and parameter gap at steps 1 to 600
             printed, and (c)'s transducer decoded with the CPU's LM
             (lm_cross); its launches exactly what its steps, evaluations,
             beam passes, LM steps and serving legs imply (_synth_expect),
             every kernel of its path among them
 45 synth_kernels  each kernel shape of those runs (recorded as they ran,
             the GRU and int8 kernels too) against its plain version, each
             shape once, as preset_kernels
 46 soak     the port's training soak
             (edgedict_tpu_torch/scripts/soak_train.py) at E6D2's full width
             (char vocabulary, bf16), 256 utterances of 8 s at batch 64, 60
             steps: every leg a cli.baseline child on cuda; the SIGKILL hit
             a live child, a checkpoint survived, both resume legs' final
             checkpoints byte-identical, the final leg exited 0 at --steps,
             every child on cuda, no NaN-skipped loss, the loss fell, the
             device-rate probe parsed; each leg that ended by itself
             launched exactly what its steps and evaluation imply; prints
             the soak's report
 47 soak_kernels  each kernel shape of those legs (recorded in the
             children) against its plain version, as synth_kernels; the
             prediction net's lookup (_Embedding) at a step's ids against
             F.embedding: bit-stable gradient, timed
 48 launches every kernel launched by the main paths themselves: the counts
             are zeroed just before each measured cuda decode_wav (LSTM
             fp32 / int8, GRU fp32 / int8, the three beam runs), just
             before the clients of each server connect, just before the
             measured train steps and cli.train_lm, and read just after
             each, so no warm-up, reference or comparison call is counted;
             the decodes' counts must equal what their encoder calls imply
             (per call: int8 LSTM K11 7, K12 6, K1 0; GRU K5 6; int8 GRU
             K11 7, K13 6, K5 0), the beam decodes' K2 = chunks, K3 = 0 and
             K1 = the encoder's + frames x 3 expansions x (2 prediction-net
             + 2 LM layers with fusion), the train counts what the steps
             imply (per micro-step: LSTM 8 K1 and 8 K4, GRU 6 K5, 6 K6, 2
             K1 and 2 K4; one of K2 and K7-K10 each), cli.train_lm's 2 K1
             and 2 K4 a step; every K11 launch of the int8 server is a
             tiled one; the beam server launches K1 and K2 and no K3;
             the wav2vec runs exactly what their steps imply, every other
             kernel 0 (pretraining: 6 K1 and 6 K4 a micro-step, 6 K1 an
             eval batch; the fine-tune: 8 K1, 8 K4 and one of K7-K10 a
             micro-step; its eval: 16 K1 and one of K3, K7 and K9 a
             batch); the train_run phases' --mode eval passes exactly what
             evaluate() implies (per batch K2, K3, K7, K9 once, the
             encoder's and the prediction net's layers twice; the LSTM
             run's W=4 beam adds K2 and 8 K1 a batch and 6 K1 an encoder
             frame); train_features' three modes and its profiled
             Trainer.train what their micro-steps imply, as train_run; the
             JAX run's decode K2 and K3 a chunk and K1 per encoder layer
             a chunk, its resumed step what its micro-steps imply; the
             exported decodes and wer_parity's cuda eval as phases 23 and 24
             state; the ctc and legacy runs exactly what their layers
             imply (a CTC step: K1 and K4 per encoder layer; its decode K1
             per layer; the legacy loss: K1 and K4 per encoder and
             prediction-net layer, one K9 and one K10; its decode: K1 per
             encoder layer, once for the BOS priming and once a frame;
             RNNModel: K1 per layer); surface's one K2; each dp rank what its
             3 micro-steps imply (as train_run); the sharded servers'
             rounds what two replicas of 4 streams imply (per round and
             replica: K2, the encoder's kernels as the decodes, K3 for
             greedy, the beam's K1 a frame as the beam runs); the pp and
             tp steps what their micro-steps imply, as train_run, with K7
             and K8 once a vocabulary slice; the LARGE and E4D1 decodes
             K2 and K3 once and K1 once per encoder layer a chunk, their
             steps and eval passes as train_run's; the LARGE servers one
             K2 and six K1 per K3 launch (a round), no other kernel; the
             defaults' decode, servers, steps and eval as LARGE's (four K1
             a chunk or round); the int8 GRU server one K2 and K3, 7 tiled
             K11 and 6 K13 a round, no other kernel; each learning run
             what _synth_expect states; each soak leg that ended by itself
             what _soak_expect states: the children's counts, zeroed as
             each child starts and read as it ends)
Then the kernels JSON line, the nvidia-smi line and, only when every phase
passed, {"ok": true, "device": {...}} as the last line.  Any failure exits
non-zero; without a CUDA card nothing runs.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
STATE = {}     # results shared between phases


class SmokeFailure(Exception):
    pass


def emit(obj):
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    require(r.returncode == 0, f'nvidia-smi failed: {r.stderr.strip()}')
    return r.stdout.strip().splitlines()[0]


def set_numerics(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def untimed():
    """Within: the kernel cases check and do not time: time_pair,
    _median_ms, layer_times, quant_layer_times, kernel_split_ms,
    device_ms_per_launch and queued_ms return None (or nothing) without
    calling; the profiler's launch checks (_profiled_us) still run.  For
    shapes whose kernels an earlier case timed."""
    STATE['untimed'] = True
    try:
        yield
    finally:
        STATE['untimed'] = False


def _median_ms(torch, fn, iters=20, warmup=3):
    if STATE.get('untimed'):
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# a plain version slower than this a call is timed once each side, not 20
# times (the long cases' plain versions take tens of ms to seconds, and
# the smoke's time is bounded)
LONG_PLAIN_MS = 20.0


def time_pair(torch, plain, kernel, kernel_iters=20):
    """(kernel ms, plain ms), each the mean of two medians taken in the
    order plain, kernel, kernel, plain: medians of 20 timings (the
    kernel's: kernel_iters) after 3 warm-up calls; where one call of the
    plain version (after one warm-up call) takes over LONG_PLAIN_MS, that
    call is its first timing and one more call after the kernel's its
    second.  (None, None) untimed()."""
    if STATE.get('untimed'):
        return None, None
    plain()
    p1 = _median_ms(torch, plain, 1, 0)
    long_plain = p1 > LONG_PLAIN_MS
    if not long_plain:
        p1 = _median_ms(torch, plain, min(20, kernel_iters), 3)
    k1 = _median_ms(torch, kernel, kernel_iters)
    k2 = _median_ms(torch, kernel, kernel_iters)
    p2 = _median_ms(torch, plain, *((1, 0) if long_plain
                                    else (min(20, kernel_iters), 3)))
    return (k1 + k2) / 2, (p1 + p2) / 2


# the H100 SXM's published peaks (NVIDIA's data sheet; dense): device memory
# rate and the operation rate of each input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'fp32': 67e12, 'bf16': 989e12}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, n_ops, kind):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of the bytes moved (each input read once, each output
    written once) over the memory rate and the operations over the peak of
    their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# seeded normal draws of more than this many elements are made on the card
# (the host's draw of the long cases' inputs takes seconds)
BIG_DRAW = 1 << 24


def randn(torch, rng, dev, shape, scale=1.0):
    """rng.randn(*shape) * scale as an fp32 tensor on dev; a draw of more
    than BIG_DRAW elements comes from a torch.Generator on dev seeded from
    rng."""
    if int(np.prod(shape)) <= BIG_DRAW:
        return torch.as_tensor((rng.randn(*shape) * scale)
                               .astype(np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))
    return torch.randn(tuple(shape), generator=gen, device=dev) * scale


def kind_of(torch, t):
    return 'bf16' if t.dtype == torch.bfloat16 else 'fp32'


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    STATE['kind'] = name
    STATE['smi'] = nvidia_smi_line()
    emit({'phase': 'device', 'name': name,
          'count': torch.cuda.device_count(), 'nvidia_smi': STATE['smi'],
          'torch': torch.__version__, 'cuda': torch.version.cuda})


def phase_build(torch):
    from edgedict_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info['log'].splitlines()
             if 'registers' in ln or 'spill' in ln or 'Compiling entry' in ln]
    emit({'phase': 'build', 'seconds': round(time.perf_counter() - t0, 3),
          'nvcc_seconds': round(info['seconds'], 3),
          'cached': info['cached'], 'library': os.path.relpath(
              info['path'], REPO)})
    for ln in ptxas:
        emit(f'ptxas: {ln}')


def _close(a, b, atol, rtol):
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    ok = bool((diff <= atol + rtol * b.abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def fwd_plan(x_proj, gates, quant=False):
    """K1/K5/K12's launch plan for x_proj (ops/rnn_fwd.py, from the
    card)."""
    import dataclasses

    from edgedict_tpu_torch.ops import rnn_fwd
    return dataclasses.asdict(rnn_fwd.card_plan(x_proj, gates, quant))


def lstm_steps_plain(torch, K1, xp, w, h0, c0, ys, cs):
    """Each step of the plain recurrence, started from the state the
    kernel itself carried into it: (h, c) = (h0, c0) at t=0, else
    (ys[t-1], cs[t-1]).  ys[t-1] is h rounded to x_proj's dtype, which is
    what the kernel feeds the recurrent dot."""
    t, b, h4 = xp.shape
    h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, -1)
    c_prev = torch.cat([c0[None], cs[:-1]]).reshape(t * b, -1)
    y1, c1, _ = K1.lstm_recurrence_plain(xp.reshape(1, t * b, h4), w,
                                         h_prev, c_prev)
    return y1.reshape(ys.shape), c1.reshape(cs.shape)


def phase_kernels(torch):
    import dataclasses

    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.ops import decode_kernel as K3
    from edgedict_tpu_torch.models import transducer as T
    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    summary = {}

    def record(name, err, ms=None, plain_ms=None, bounds=None,
               library_ms=None, device_ms=None):
        """Keep the largest error, and the times and bound of the first
        timed main-path case (its device time by torch.profiler where
        given)."""
        s = summary.setdefault(name, {'max_abs_err': 0.0})
        s['max_abs_err'] = max(s['max_abs_err'], err)
        if ms is not None and 'ms' not in s:
            s['ms'], s['plain_ms'], s['library_ms'] = ms, plain_ms, library_ms
            s['bound_ms'], s['bound_by'] = bounds
            if device_ms is not None:
                s['device_ms'] = device_ms

    # K2 — mel power, E6D2 featurizer (n_fft 512, win 320, hop 200, 80 mels)
    # at the chunk (1, 8 and 64 streams), 4 s, the train step's 32 x 16 s,
    # the shortest legal row and one off the hop grid: both splits of its
    # plan (ops/features_plan.py), each bit-stable across two calls; device
    # time by torch.profiler at the chunk and the train step
    cfg = F.FeatureConfig(feature_type='logfbank', feature_size=80,
                          n_fft=512, win_length=320, hop_length=200,
                          downsample=3, pad_to_divisible=False)
    pipe = F.FeaturePipeline(cfg, dev)
    for b, length in ((1, 1320), (8, 1320), (64, 1320), (1, 64000),
                      (8, 64000), (32, 256000), (1, 257), (1, 1399)):
        mel_case(torch, rng, dev, record, pipe.tables, b, length,
                 timed=length in (1320, 256000) or b == 1,
                 profiled=(b, length) in ((1, 1320), (32, 256000)),
                 main=(b, length) == (1, 1320))

    # K1 — LSTM recurrence, encoder (H=1024) and prediction net (H=256, and
    # E6D2_LARGE_Batch's 512); the persistent kernel's 32-row slabs at the
    # ragged B=33 and the server's 256
    cases = [(1024, b, t, dt) for dt in (torch.float32, torch.bfloat16)
             for b in (1, 8) for t in (1, 2, 16)]
    cases += [(256, b, t, torch.float32) for b in (1, 8) for t in (1, 2)]
    cases += [(1024, 33, 3, torch.bfloat16), (1024, 256, 2, torch.float32),
              (512, 32, 2, torch.bfloat16)]
    for hid, b, t, dt in cases:
        lstm_fwd_case(torch, rng, dev, record, hid, b, t, dt)

    # K3 — greedy frame loop at E6D2's joint / prediction-net widths: one
    # stream (T=1: a streaming chunk), the fp32 server's 8 and the int8
    # server's 64 streams, and the trainer's eval decode (B=4 over a whole
    # utterance, T=214)
    dcfg = T.TransducerConfig(vocab_size=2048, vocab_embed_size=64,
                              enc_hidden_size=8, enc_layers=1,
                              enc_proj_size=640, dec_hidden_size=256,
                              dec_layers=2, dec_proj_size=256,
                              joint_size=640)
    # blank bias 0: every frame emits; 1.8: about half blank; 6: all blank
    k3_timed = []      # (case, args): device time by the profiler, last
    for blank_bias in (0.0, 1.8, 6.0):
        model = T.Transducer(dcfg, device=dev, seed=1)
        with torch.no_grad():
            model.joint.out.bias[dcfg.blank] += blank_bias
            model.joint.out.bias[3] += 0.0 if blank_bias else 4.0  # <unk>
        cache = K3.build_decode_cache(model)
        for b, t in ((1, 1), (1, 16), (8, 1), (8, 16), (64, 1), (4, 214)):
            with torch.no_grad():
                h_dec0, (hs, cs) = T.decoder_apply(
                    model.decoder, dcfg,
                    torch.zeros((b, 0), dtype=torch.long, device=dev))
            h_dec0 = h_dec0[:, 0].contiguous()
            f = torch.as_tensor(rng.randn(t, b, 640).astype(np.float32),
                                device=dev)
            for emit_logp in (False, True):
                args = (cache, f, h_dec0, hs, cs, 0, 3, emit_logp)
                out = K3.greedy_frame_loop(*args)
                again = K3.greedy_frame_loop(*args)
                ref = K3.greedy_frame_loop_plain(*args)
                torch.cuda.synchronize()
                tok_eq = bool(torch.equal(out[0], ref[0]))
                errs = [_close(a, r, 1e-4, 1e-4) for a, r in
                        zip(out[1:], ref[1:]) if a is not None]
                err = max(e for _, e in errs)
                stable = all(torch.equal(a, c) for a, c in zip(out, again)
                             if a is not None)
                case = {'kernel': 'K3 greedy_decode', 'B': b, 'T': t,
                        'emit_logp': emit_logp, 'unk': 3,
                        'blank_bias': blank_bias, 'tokens_equal': tok_eq,
                        'blank_share': float((ref[0] == 0).float().mean()),
                        'state_max_abs': err, 'bit_stable': stable,
                        'tol': 'tokens exact, atol 1e-4 rtol 1e-4',
                        'plan': dataclasses.asdict(K3.card_plan(cache, f,
                                                                hs))}
                main = (b, t, emit_logp, blank_bias) == (1, 1, False, 0.0)
                if not emit_logp and (t == 1 or b == 1 or (
                        t == 214 and blank_bias == 1.8)):
                    ms, pms = time_pair(
                        torch, lambda: K3.greedy_frame_loop_plain(*args),
                        lambda: K3.greedy_frame_loop(*args))
                    case.update(ms=ms, plain_ms=pms)
                    if t == 1 or t == 214:
                        k3_timed.append(({key: case[key] for key in (
                            'B', 'T', 'blank_bias')}, args))
                bounds = k3_bound(torch, cache, args, out)
                case.update(bound_ms=bounds[0], bound_by=bounds[1])
                emit(case)
                require(tok_eq and all(ok for ok, _ in errs) and stable,
                        f'K3 disagrees: {case}')
                record('greedy_decode', err,
                       case.get('ms') if main else None,
                       case.get('plain_ms'), bounds)
    train_kernels(torch, rng, dev, record)
    train_shape_forward(torch, rng, dev, record)
    summary['quant_matmul_tile']['cases'] = serving_kernels_q(torch, rng, dev,
                                                              record)
    # K3's device time by torch.profiler (None where no profiled run
    # recorded a launch)
    for key, args in k3_timed:
        ms, n = device_ms_per_launch(
            torch, lambda: K3.greedy_frame_loop(*args), 'greedy_frame_kernel')
        emit({'kernel': 'K3 greedy_decode', **key, 'device_ms': ms,
              'profiled_launches': n})
        if key == {'B': 1, 'T': 1, 'blank_bias': 0.0}:
            summary['greedy_decode']['device_ms'] = ms
    beam_kernels(torch, dev, record)
    wav2vec_kernels(torch, dev, record)
    STATE['kernels'] = summary
    STATE['record'] = record            # phase_wav2vec_kernels' cases


def mel_case(torch, rng, dev, record, tables, b, length, timed=True,
             profiled=False, main=False):
    """K2 against its plain version on seeded audio (B, length) (a
    near-silent first quarter) through the featurizer's tables: log-mel to
    atol 5e-3 rtol 1e-3, bit-stable across two calls, with its plan (both
    splits of ops/features_plan.py); timed in turns where `timed`, its
    device ms by torch.profiler where `profiled`; `main`: the case whose
    times stand in the kernels line."""
    import dataclasses

    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.ops import features_kernel as K2
    from edgedict_tpu_torch.ops import features_plan as KP
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_freq, n_mels = tables.mel_t.shape
    audio = torch.as_tensor(
        (rng.randn(b, length) * 0.1).astype(np.float32), device=dev)
    audio[:, : length // 4] *= 1e-4           # near-silent stretch
    audio = F.preemphasis(audio)
    ker = K2.mel_power(audio, tables)
    again = K2.mel_power(audio, tables)
    ref = K2.mel_power_plain(audio, tables)
    torch.cuda.synchronize()
    ok, err = _close(torch.log(ker + F.LOG_GUARD),
                     torch.log(ref + F.LOG_GUARD), 5e-3, 1e-3)
    _, perr = _close(ker, ref, 0.0, 0.0)
    case = {'kernel': 'K2 mel_power', 'B': b, 'samples': length,
            'n_fft': tables.n_fft, 'hop': tables.hop, 'mels': n_mels,
            'frames': ker.shape[1], 'logmel_max_abs': err,
            'power_max_abs': perr, 'bit_stable': torch.equal(ker, again),
            'tol': 'log-mel atol 5e-3 rtol 1e-3',
            'plan': dataclasses.asdict(KP.mel_plan(
                b, length, tables.n_fft, tables.hop, n_mels, sms))}
    if timed:
        ms, pms = time_pair(torch, lambda: K2.mel_power_plain(audio, tables),
                            lambda: K2.mel_power(audio, tables))
        case.update(ms=ms, plain_ms=pms)
    if profiled:
        dms, n = device_ms_per_launch(
            torch, lambda: K2.mel_power(audio, tables), 'mel_power_kernel')
        case.update(device_ms=dms, profiled_launches_per_call=n / 5)
    # what the function needs, not what the kernel's DFT-as-a-product
    # does: bytes of the audio, the window, the filterbank's nonzero
    # weights (each mel's band) and the output; operations per frame of
    # the window, a real FFT (2.5·n·log2 n flop), the power and each
    # mel over its band
    band = tables.mel_band
    weights = int((band[:, 1] - band[:, 0]).sum())
    frames = b * ker.shape[1]
    n_fft = tables.n_fft
    bounds = bound(nbytes(audio, tables.window, band, ker) + 4 * weights,
                   frames * (n_fft + 2.5 * n_fft * np.log2(n_fft)
                             + 3 * n_freq + 2 * weights), 'fp32')
    case.update(bound_ms=bounds[0], bound_by=bounds[1])
    emit(case)
    require(ok and case['bit_stable'], f'K2 disagrees: {case}')
    record('mel_power', err, case.get('ms') if main else None,
           case.get('plain_ms'), bounds, device_ms=case.get('device_ms'))


def lstm_fwd_case(torch, rng, dev, record, hid, b, t, dt, beam_step=False,
                  bit_stable=False, n_in=None):
    """K1 against its plain version at (H, B, T, dtype), free-running and
    step by step from the kernel's own state, with its plan, timed where
    T < 16 or B = 1; a beam step also beside one cuDNN layer with the
    beam's input width and with its device ms; bit_stable: the same bits
    on a second call; n_in: the layer's input width, given where the case
    is also timed beside one cuDNN layer of that width."""
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    k = 1.0 / hid ** 0.5
    xp = randn(torch, rng, dev, (t, b, 4 * hid)).to(dt)
    w = torch.as_tensor(rng.uniform(-k, k, (4 * hid, hid))
                        .astype(np.float32), device=dev).to(dt)
    h0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                         device=dev)
    c0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                         device=dev)
    ys, cs, hT = K1.lstm_recurrence(xp, w, h0, c0)
    rys, rcs, rhT = K1.lstm_recurrence_plain(xp, w, h0, c0)
    step_ys, step_cs = lstm_steps_plain(torch, K1, xp, w, h0, c0, ys, cs)
    torch.cuda.synchronize()
    # free-running, bf16 drifts: a one-ulp flip of h's bf16 rounding
    # feeds every later step.  Step by step from the kernel's own state,
    # cs is held to the fp32 bound, so a kernel that fed fp32 h to the
    # dot (no bf16 cast) fails; bf16 ys may still differ by one ulp
    run_tol = (1e-4, 1e-4) if dt == torch.float32 else (2e-2, 2e-2)
    ys_tol = (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 0.0)
    oks, errs = zip(*[_close(a, r, *tol) for a, r, tol in
                      ((ys, rys, run_tol), (cs, rcs, run_tol),
                       (hT, rhT, run_tol), (ys, step_ys, ys_tol),
                       (cs, step_cs, (1e-4, 1e-4)))])
    case = {'kernel': 'K1 lstm_fwd', 'H': hid, 'B': b, 'T': t,
            'dtype': str(dt).split('.')[-1], 'ys_max_abs': errs[0],
            'cs_max_abs': errs[1], 'hT_max_abs': errs[2],
            'step_ys_max_abs': errs[3], 'step_cs_max_abs': errs[4],
            'tol': f'run atol {run_tol[0]} rtol {run_tol[1]}; per step '
                   f'ys atol {ys_tol[0]} rtol {ys_tol[1]}, cs atol 1e-4 '
                   'rtol 1e-4', 'plan': fwd_plan(xp, 4)}
    main = (hid, b, t, dt) == (1024, 1, 2, torch.float32)
    if t != 16 or b == 1:
        ms, pms = time_pair(
            torch, lambda: K1.lstm_recurrence_plain(xp, w, h0, c0),
            lambda: K1.lstm_recurrence(xp, w, h0, c0))
        case.update(ms=ms, plain_ms=pms)
    if main:
        case.update(layer_times(torch, 'LSTM', hid, b, t, dt, False))
    if n_in:
        case.update(layer_times(torch, 'LSTM', hid, b, t, dt, False, n_in))
    if beam_step:
        # the layer's input: E6D2's 64-wide label embedding, the LM's
        # 256-wide one
        case.update(layer_times(torch, 'LSTM', hid, b, t, dt, False,
                                n_in=64 if hid == 256 else 256))
        case['device_ms'], _ = device_ms_per_launch(
            torch, lambda: K1.lstm_recurrence(xp, w, h0, c0),
            'recur_fwd_kernel')
    if bit_stable:
        again = K1.lstm_recurrence(xp, w, h0, c0)
        case['bit_stable'] = all(torch.equal(a, c) for a, c in
                                 zip((ys, cs, hT), again))
        oks += (case['bit_stable'],)
    bounds = bound(nbytes(xp, w, h0, c0, ys, cs, hT),
                   2 * t * b * 4 * hid * hid, kind_of(torch, xp))
    case.update(bound_ms=bounds[0], bound_by=bounds[1])
    emit(case)
    require(all(oks), f'K1 disagrees: {case}')
    record('lstm_fwd', max(errs), case.get('ms') if main else None,
           case.get('plain_ms'), bounds, case.get('library_ms'))


def lstm_bwd_case(torch, rng, dev, record, hid, b, t, dt, n_in=None):
    """K4 against its plain version at (H, B, T, dtype), timed, split into
    its two launches by the profiler; the E6D2 encoder's also beside one
    cuDNN layer, and given the layer's input width n_in beside one of that
    width."""
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    fp32 = torch.float32

    def t_(*shape, scale=1.0, dtype=fp32):
        return randn(torch, rng, dev, shape, scale).to(dtype)

    k = 1.0 / hid ** 0.5
    xp = t_(t, b, 4 * hid, dtype=dt)
    w = torch.as_tensor(rng.uniform(-k, k, (4 * hid, hid))
                        .astype(np.float32), device=dev).to(dt)
    h0, c0 = t_(b, hid, scale=0.5), t_(b, hid, scale=0.5)
    ys, cs, _ = K1.lstm_recurrence(xp, w, h0, c0)
    dys = t_(t, b, hid, dtype=dt)
    args = (xp, w, h0, c0, ys, cs, dys, None, None)
    out = K1.lstm_recurrence_bwd(*args)
    ref = K1.lstm_recurrence_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [_rel(torch, a, r) for a, r in zip(out, ref)]
    tol = 1e-4 if dt == fp32 else 2e-2
    case = {'kernel': 'K4 lstm_bwd', 'H': hid, 'B': b, 'T': t,
            'dtype': str(dt).split('.')[-1], 'dgates_rel': errs[0],
            'dh0_rel': errs[1], 'dc0_rel': errs[2],
            'tol': f'max|d| / max(1, max|ref|) <= {tol}'}
    ms, pms = time_pair(torch, lambda: K1.lstm_recurrence_bwd_plain(*args),
                        lambda: K1.lstm_recurrence_bwd(*args))
    bounds = bound(nbytes(xp, w, h0, c0, ys, cs, dys, *out),
                   4 * t * b * 4 * hid * hid, kind_of(torch, xp))
    case.update(ms=ms, plain_ms=pms, bound_ms=bounds[0],
                bound_by=bounds[1])
    main = (hid, t) == (1024, 427)
    case.update(kernel_split_ms(
        torch, lambda: K1.lstm_recurrence_bwd(*args), BWD_PARTS))
    if main:
        case.update(layer_times(torch, 'LSTM', hid, b, t, dt, True))
    if n_in:
        case.update(layer_times(torch, 'LSTM', hid, b, t, dt, True, n_in))
    emit(case)
    require(max(errs) <= tol, f'K4 disagrees: {case}')
    record('lstm_bwd', max(errs), ms if main else None, pms, bounds,
           case.get('library_ms'))


def beam_kernels(torch, dev, record):
    """K1 at the beam paths' shapes, B·W rows (W=4) and T = 1: the
    prediction net (H=256) of one stream, of train_run's beam eval (eval
    batch 4) and of server_beam's 8 streams; the LM (H=512) of one stream
    in fp32 and bf16 and of server_beam's 8 streams; K1 and K4 at
    lm_train's LM_TRAIN (H=512, E6D2's batch 32, T=64).  Each K1 case
    bit-stable; run after every other kernel case, on data of its own
    seed, so the earlier cases see the data and the allocator they saw
    before the beam was ported."""
    fp32 = torch.float32
    rng = np.random.RandomState(12)
    w_ = BEAM['beam_width']
    steps = ((256, w_, 1, fp32), (512, w_, 1, fp32))
    for case in (*steps, (256, w_ * EVAL_BATCH, 1, fp32),
                 (256, w_ * SERVER_BEAM_STREAMS, 1, fp32),
                 (512, w_ * SERVER_BEAM_STREAMS, 1, fp32),
                 (512, w_, 1, torch.bfloat16), (*LM_TRAIN, fp32)):
        lstm_fwd_case(torch, rng, dev, record, *case,
                      beam_step=case in steps, bit_stable=True)
    lstm_bwd_case(torch, rng, dev, record, *LM_TRAIN, fp32)


# the wav2vec slice: the FrontEnd's 128 channels are the first encoder
# layer's input; phase_wav2vec_kernels holds each kernel at the shapes the
# pretraining and raw fine-tune runs gave it, wav2vec_kernels beside them
# at a 16 s lattice of E6D2's U+1 = 65
FRONTEND_C = 128
RAW_T = 1597               # FrontEnd frames of 256,000 samples (16 s)
RAW_U1 = 65


def wav2vec_kernels(torch, dev, record):
    """K1, K4 and K7-K10 at a 16 s raw fine-tune step with E6D2's U+1 = 65
    (B=32 T=1597, after every other case, on their own seed), beside the
    shapes of the runs themselves (phase_wav2vec_kernels, which times
    them at the run's B=32 T=1601 U+1=49): checked, not timed (untimed());
    K1 bf16 held step by step, K4, the lattice (K9, K10), the joint (K7,
    K8) against the plain joint by time chunks; then library_rows."""
    bf16 = torch.bfloat16
    rng = np.random.RandomState(13)
    with untimed():
        bf16_forward_case(torch, rng, dev, record, 'LSTM', 32, RAW_T,
                          FRONTEND_C)
        lstm_bwd_case(torch, rng, dev, record, 1024, 32, RAW_T, bf16,
                      n_in=FRONTEND_C)
        xlen = rng.randint(RAW_T * 3 // 4, RAW_T + 1, 32)
        ylen = rng.randint(40, RAW_U1, 32)
        lattice_long_cases(torch, rng, dev, record, 32, RAW_T, RAW_U1, xlen,
                           ylen)
        joint_long_case(torch, rng, dev, record, 32, RAW_T, RAW_U1, bf16)
    library_rows(torch)


def lattice_long_cases(torch, rng, dev, record, b, t, u1, xlen, ylen,
                       backward=True):
    """K9 (and with backward K10 on its alpha) at a long lattice of seeded
    log-probs and the given lengths, the plain versions in fp64; run
    before the joint's GB-sized references, the allocator's cache emptied
    first (K9's no-extra-memory check counts allocated blocks)."""
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    logits = torch.as_tensor(rng.randn(b, t, u1, 2).astype(np.float32),
                             device=dev)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    case = (lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous(),
            *(torch.as_tensor(np.asarray(x, np.int32), device=dev)
              for x in (xlen, ylen)))
    del logits, lp
    torch.cuda.empty_cache()
    k9_cases(torch, record, [case])
    if backward:
        k10_cases(torch, record, [(*case, *KL.lattice_alpha(*case))],
                  wide=True)


def _plain_joint_by_chunks(torch, KJ, f, g, w_t, bias, labels, chunk,
                           cot=None):
    """The plain joint (fused_joint_lse_plain) over `chunk` frames at a
    time, as rnnt_loss_from_joint's CPU path runs it: → (blank_lp,
    label_lp), and with cot = (d_b, d_l) also the gradients of f, g, w_t
    and bias (each chunk's forward recomputed under autograd)."""
    parts, df, rest = [], [], None
    for s0 in range(0, f.shape[1], chunk):
        f_c = f[:, s0:s0 + chunk]
        if cot is None:
            with torch.no_grad():
                parts.append(KJ.fused_joint_lse_plain(f_c, g, w_t, bias,
                                                      labels, 0))
            continue
        leaves = [x.detach().clone().requires_grad_()
                  for x in (f_c, g, w_t, bias)]
        out = KJ.fused_joint_lse_plain(*leaves, labels, 0)
        gr = torch.autograd.grad(out, leaves, (cot[0][:, s0:s0 + chunk],
                                               cot[1][:, s0:s0 + chunk]))
        df.append(gr[0])
        rest = list(gr[1:]) if rest is None else [
            a + c for a, c in zip(rest, gr[1:])]
    if cot is None:
        return tuple(torch.cat(p, 1) for p in zip(*parts))
    return (torch.cat(df, 1), *rest)


def joint_long_case(torch, rng, dev, record, b, t, u1, dt, j=640, v=2048):
    """K7 (and in bf16 K8) at a lattice (B, T, U+1) and widths J, V (the raw
    fine-tune's: E6D2's 640, 2048) against the plain joint run 100 frames
    at a time (the whole (B, T, U+1, V) logits of the raw fine-tune do not
    fit the card), timed in turns with the plain version twice: log-probs
    to 1e-4 and gradients to 2e-2 of max(1, max|ref|), as at the E6D2
    step."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    chunk = 100

    def t_(*shape, scale=1.0):
        return randn(torch, rng, dev, shape, scale)
    f, g = t_(b, t, j).to(dt), t_(b, u1, j).to(dt)
    w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
    labels = torch.as_tensor(rng.randint(4, v, (b, u1 - 1)).astype(np.int32),
                             device=dev)
    d_b, d_l = t_(b, t, u1, scale=0.1), t_(b, t, u1 - 1, scale=0.1)
    wt_e = w_t.to(dt).contiguous()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    blank_lp, label_lp, lse = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
    fwd_extra = torch.cuda.max_memory_allocated() - base
    plain = lambda: _plain_joint_by_chunks(  # noqa: E731
        torch, KJ, f, g, w_t, bias, labels, chunk)
    ref = plain()
    torch.cuda.synchronize()
    fwd_err = max(_rel(torch, blank_lp, ref[0]), _rel(torch, label_lp, ref[1]))
    again = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
    ms, pms = time_pair(torch, plain, lambda: KJ.joint_lse_fwd(
        f, g, wt_e, bias, labels, 0))
    lattice_ops = 2 * b * t * u1 * j * v
    fwd_bound = bound(nbytes(f, g, wt_e, bias, labels, blank_lp, label_lp,
                             lse), lattice_ops, kind_of(torch, f))
    case = {'kernel': 'K7 joint_lse_fwd', 'B': b, 'T': t, 'U1': u1, 'J': j,
            'V': v, 'dtype': str(dt).split('.')[-1], 'fwd_rel': fwd_err,
            'bit_stable': all(torch.equal(a, c) for a, c in
                              zip((blank_lp, label_lp, lse), again)),
            'fwd_ms': ms, 'fwd_plain_ms': pms,
            'fwd_plain': f'fused_joint_lse_plain by {chunk} frames',
            'fwd_bound_ms': fwd_bound[0], 'fwd_bound_by': fwd_bound[1],
            'fwd_extra_mb': fwd_extra / 2 ** 20,
            'tol': 'lp 1e-4, grads 2e-2, of max(1, max|ref|)'}
    del ref, again
    ok = fwd_err <= 1e-4 and case['bit_stable']
    record('joint_lse_fwd', fwd_err)
    if dt == torch.bfloat16:
        case['kernel'] = 'K7/K8 joint_lse'
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads = KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, d_b, d_l)
        bwd_extra = torch.cuda.max_memory_allocated() - base
        ref_g = _plain_joint_by_chunks(torch, KJ, f, g, w_t, bias, labels,
                                       chunk, (d_b, d_l))
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) for a, r in zip(grads, ref_g)]
        del ref_g
        bms, bpms = time_pair(
            torch, lambda: _plain_joint_by_chunks(
                torch, KJ, f, g, w_t, bias, labels, chunk, (d_b, d_l)),
            lambda: KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, d_b,
                                     d_l))
        bwd_bound = bound(nbytes(f, g, wt_e, bias, labels, lse, d_b, d_l,
                                 *grads), 3 * lattice_ops, kind_of(torch, f))
        case.update(df_rel=errs[0], dg_rel=errs[1], dw_rel=errs[2],
                    dbias_rel=errs[3], bwd_ms=bms, bwd_plain_ms=bpms,
                    bwd_plain='the same by chunks, forward recomputed',
                    bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
                    bwd_extra_mb=bwd_extra / 2 ** 20,
                    bwd_parts_ms=kernel_split_ms(
                        torch, lambda: KJ.joint_lse_bwd(
                            f, g, wt_e, bias, labels, 0, lse, d_b, d_l),
                        K8_PARTS, n=2))
        ok = ok and max(errs) <= 2e-2
        record('joint_lse_bwd', max(errs))
    emit(case)
    require(ok, f'K7/K8 disagree at the raw lattice: {case}')


def k3_long_case(torch, rng, dev, record, b, t):
    """K3 at a long decode, (B, T) at E6D2's joint and prediction-net
    widths (blank bias 1.8 as the E6D2 eval case: most frames blank, as a
    trained model's), called as models/decoding.py's greedy decode calls
    it (no <unk> id, log-probs emitted): k3_check."""
    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.ops import decode_kernel as K3
    dcfg = T.TransducerConfig(vocab_size=2048, vocab_embed_size=64,
                              enc_hidden_size=8, enc_layers=1,
                              enc_proj_size=640, dec_hidden_size=256,
                              dec_layers=2, dec_proj_size=256,
                              joint_size=640)
    model = T.Transducer(dcfg, device=dev, seed=1)
    with torch.no_grad():
        model.joint.out.bias[dcfg.blank] += 1.8
    cache = K3.build_decode_cache(model)
    with torch.no_grad():
        h_dec0, (hs, cs) = T.decoder_apply(
            model.decoder, dcfg, torch.zeros((b, 0), dtype=torch.long,
                                             device=dev))
    f = torch.as_tensor(rng.randn(t, b, 640).astype(np.float32), device=dev)
    k3_check(torch, record, (cache, f, h_dec0[:, 0].contiguous(), hs, cs, 0,
                             None, True), blank_bias=1.8)


def k3_check(torch, record, args, **info):
    """K3 against its plain version on greedy_frame_loop's args: tokens
    exact, states (and log-probs) to 1e-4, bit-stable, timed in turns,
    device ms by the profiler, or where it recorded no launch by CUDA
    events around queued calls (queued_ms); `info` goes into the printed
    case."""
    import dataclasses

    from edgedict_tpu_torch.ops import decode_kernel as K3
    cache, f, hs = args[0], args[1], args[3]
    out = K3.greedy_frame_loop(*args)
    again = K3.greedy_frame_loop(*args)
    ref = K3.greedy_frame_loop_plain(*args)
    torch.cuda.synchronize()
    tok_eq = bool(torch.equal(out[0], ref[0]))
    errs = [_close(a, r, 1e-4, 1e-4) for a, r in zip(out[1:], ref[1:])
            if a is not None]
    ms, pms = time_pair(torch, lambda: K3.greedy_frame_loop_plain(*args),
                        lambda: K3.greedy_frame_loop(*args))
    dms, n = device_ms_per_launch(torch, lambda: K3.greedy_frame_loop(*args),
                                  'greedy_frame_kernel', n=2)
    dms_by = 'torch.profiler'
    if dms is None:
        dms = queued_ms(torch, lambda: K3.greedy_frame_loop(*args))
        dms_by = 'cuda events, queued calls'
    bounds = k3_bound(torch, cache, args, out)
    j, v = cache['w_out_t'].shape
    case = {'kernel': 'K3 greedy_decode', 'B': f.shape[1], 'T': f.shape[0],
            'J': j, 'V': v, **info, 'tokens_equal': tok_eq,
            'blank_share': float((ref[0] == args[5]).float().mean()),
            'state_max_abs': max(e for _, e in errs),
            'bit_stable': all(torch.equal(a, c) for a, c in zip(out, again)
                              if a is not None),
            'ms': ms, 'plain_ms': pms, 'device_ms': dms,
            'device_ms_by': dms_by, 'profiled_launches': n,
            'bound_ms': bounds[0],
            'bound_by': bounds[1], 'tol': 'tokens exact, atol 1e-4 rtol 1e-4',
            'plan': dataclasses.asdict(K3.card_plan(cache, f, hs))}
    emit(case)
    require(tok_eq and all(ok for ok, _ in errs) and case['bit_stable'],
            f'K3 disagrees: {case}')
    record('greedy_decode', case['state_max_abs'])


def library_rows(torch):
    """One library call beside the kernel cases that had none: one cuDNN
    layer (K1: forward; K4, K6: forward + backward) at K1's beam and LM
    shapes (H=256 B=16/32 T=1 input 64, H=512 B=32 T=1 and T=64 input
    256), K4 at H=1024 B=32 T=64 fp32 (input 240) and H=512 B=32 T=64
    (input 256), K6 at H=1024 B=32 T=64 fp32; the wav2vec runs' K1 at
    H=1024 B=4 T=297 and T=1437 (input 128), H=256 B=32 T=49 and B=4
    T=33 / T=1 (input 64) and K4 at H=256 B=32 T=49; dequantize + one
    cuDNN layer at K12's / K13's int8-server shape (B=64 T=2)."""
    fp32 = torch.float32
    for kernel, cell, hid, b, t, n_in, backward in (
            ('K1', 'LSTM', 256, 16, 1, 64, False),
            ('K1', 'LSTM', 256, 32, 1, 64, False),
            ('K1', 'LSTM', 512, 32, 1, 256, False),
            ('K1', 'LSTM', 512, 32, 64, 256, False),
            ('K4', 'LSTM', 1024, 32, 64, ENC_IN, True),
            ('K4', 'LSTM', 512, 32, 64, 256, True),
            ('K6', 'GRU', 1024, 32, 64, ENC_IN, True),
            # the wav2vec runs' rows: pretraining's eval, the fine-tune's
            # prediction net, its eval's encoder and prediction net
            ('K1', 'LSTM', 1024, 4, 297, FRONTEND_C, False),
            ('K1', 'LSTM', 256, 32, 49, 64, False),
            ('K4', 'LSTM', 256, 32, 49, 64, True),
            ('K1', 'LSTM', 1024, 4, 1437, FRONTEND_C, False),
            ('K1', 'LSTM', 256, 4, 33, 64, False),
            ('K1', 'LSTM', 256, 4, 1, 64, False)):
        emit({'library_row': kernel, 'H': hid, 'B': b, 'T': t,
              'input': n_in, 'dtype': 'float32',
              **layer_times(torch, cell, hid, b, t, fp32, backward, n_in)})
    for kernel, cell in (('K12', 'LSTM'), ('K13', 'GRU')):
        emit({'library_row': kernel, 'H': 1024, 'B': 64, 'T': 2,
              'dtype': 'float32', 'library': 'dequantize + cuDNN layer',
              **quant_layer_times(torch, cell, 1024, 64, 2)})


def k3_bound(torch, cache, args, out):
    """K3's bound from this call's data: every frame's joint and logits,
    and the prediction net, its joint projection and an embedding row for
    each non-blank frame; the weights read once."""
    f, h_dec, hs, cs, blank = args[1], args[2], args[3], args[4], args[5]
    tokens = out[0]
    frames = tokens.numel()
    emitted = int((tokens != blank).sum())
    j, v = cache['w_out_t'].shape
    d = cache['w_dec_t'].shape[0]
    pred = sum(2 * (lay['w_ih_t'].numel() + lay['w_hh_t'].numel())
               for lay in cache['layers']) + 2 * cache['w_proj_t'].numel()
    weights = [t for k, t in cache.items() if k not in ('layers', 'table')]
    weights += [t for lay in cache['layers'] for t in lay.values()]
    n_bytes = (nbytes(f, h_dec, hs, cs, *weights, *out[:1], *out[2:])
               + emitted * cache['table'].shape[1] * 4)
    n_ops = frames * (2 * j * v + 2 * j) + emitted * (pred + 2 * d * j)
    return bound(n_bytes, n_ops, 'fp32')


def _rel(torch, a, b):
    """max |a - b| / max(1, max |b|), in fp32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


ENC_IN = 240      # E6D2 encoder layer 0's input: 80 mels stacked 3 times


def layer_times(torch, cell, hid, b, t, dt, backward, n_in=ENC_IN):
    """The library yardstick of a recurrence kernel: one cuDNN nn.LSTM /
    nn.GRU layer (num_layers=1, input (T, B, n_in), weights in the same
    dtype), forward alone or forward+backward, beside the port's own layer
    (ops/rnn.py: the cuBLAS input projection and the kernels, fp32 master
    weights as in training) timed the same way.  cuDNN computes the same
    layer function (b_hh inside the GRU's reset gate included); it is a
    layer time, the kernel's ms is the recurrence alone.  Where cuDNN
    refuses the dtype, that is recorded and fp32 is timed.
    → {'library_ms', 'library_dtype', 'layer_ms', 'cudnn'} ({}
    untimed())."""
    from edgedict_tpu_torch.ops import rnn as R
    if STATE.get('untimed'):
        return {}
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(hid + b + t)
    xs = torch.randn(t, b, n_in, generator=gen).to(dev, dt)
    dy = torch.randn(t, b, hid, generator=gen).to(dev, dt)
    mod = getattr(torch.nn, cell)(n_in, hid).to(dev)
    params = {k: getattr(mod, f'{name}_l0').detach().clone().requires_grad_()
              for k, name in (('w_ih', 'weight_ih'), ('w_hh', 'weight_hh'),
                              ('b_ih', 'bias_ih'), ('b_hh', 'bias_hh'))}
    h0 = torch.zeros(b, hid, device=dev)
    state = h0 if cell == 'GRU' else (h0, h0)
    layer = R.gru_layer_tm if cell == 'GRU' else R.lstm_layer_tm

    def run(fn, x):
        if not backward:
            with torch.no_grad():
                fn(x)
            return
        x = x.detach().requires_grad_()
        fn(x)[0].backward(dy.to(x.dtype))

    out = {'cudnn': torch.backends.cudnn.version(), 'library_dtype':
           str(dt).split('.')[-1]}
    try:
        lib_mod = mod.to(dt)
        run(lib_mod, xs)
        lib_x = xs
    except RuntimeError as e:         # cuDNN refuses the dtype: say so
        out.update(cudnn_refused=f'{out["library_dtype"]}: {e}'[:200],
                   library_dtype='float32')
        lib_mod, lib_x = mod.float(), xs.float()
    out['library_ms'] = _median_ms(torch, lambda: run(lib_mod, lib_x),
                                   iters=10, warmup=2)
    out['layer_ms'] = _median_ms(torch, lambda: run(
        lambda x: layer(params, x, state), xs), iters=10, warmup=2)
    return out


def _profiled_us(torch, fn, n):
    """{kernel name: (device µs, launches)} of one run of torch.profiler
    over n calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = out.get(e.key, (0.0, 0))
            out[e.key] = (us + e.device_time_total, count + e.count)
    return out


# the profiler on the card machine has lost kernel records of a profiled
# run (parent and change alike, PERF.md §7): a lost record only lowers a
# total, so parts are read as the largest of PROFILE_RUNS profiled runs
PROFILE_RUNS = 3


def kernel_split_ms(torch, fn, parts, n=5):
    """Device ms per call of fn for each part of `parts` ({name: substrings
    all in the kernel's name}), from torch.profiler over n calls: the
    largest of PROFILE_RUNS profiled runs' totals ({} untimed())."""
    if STATE.get('untimed'):
        return {}
    fn()
    torch.cuda.synchronize()
    best = {name: 0.0 for name in parts}
    for _ in range(PROFILE_RUNS):
        dev = _profiled_us(torch, fn, n)
        for name, subs in parts.items():
            total = sum(us for key, (us, _) in dev.items()
                        if all(sub in key for sub in subs)) / 1e3 / n
            best[name] = max(best[name], total)
    return best


def device_ms_per_launch(torch, fn, name, n=5):
    """(device ms of one launch of the kernel whose name holds `name`, the
    launches torch.profiler recorded) over n calls of fn: the mean over the
    recorded launches of the first of PROFILE_RUNS profiled runs that
    recorded one; (None, 0) when none did, or untimed()."""
    if STATE.get('untimed'):
        return None, 0
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_RUNS):
        dev = _profiled_us(torch, fn, n)
        us = sum(u for key, (u, _) in dev.items() if name in key)
        count = sum(c for key, (_, c) in dev.items() if name in key)
        if count:
            return us / 1e3 / count, count
    return None, 0


def queued_ms(torch, fn, n=10):
    """Device ms of one call of fn: CUDA events around n calls that the
    host queues while a sleep kernel holds the stream (~25 ms), so its
    dispatch between calls does not show; the mean (None untimed())."""
    if STATE.get('untimed'):
        return None
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# K4/K6's two launches: the gate remat over all steps and the dh chain
BWD_PARTS = {'remat_ms': ('remat_',), 'chain_ms': ('chain_kernel',)}
# K7's launches: the resident kernel (one), or the staged h and product
K7_PARTS = {'h_ms': ('joint_lse_fwd_h_',), 'mma_ms': ('joint_lse_fwd_mma',)}
# K8's launches, summed over the slabs (ops/joint_lse_plan.py; dh includes
# its df / dg sum launch)
K8_PARTS = {'h_ms': ('joint_lse_bwd_h_',),
            'dlogits_ms': ('joint_lse_bwd_dl_',),
            'dh_ms': ('joint_lse_bwd_dh',),
            'dw_ms': ('joint_lse_bwd_dw',),
            'reduce_ms': ('joint_lse_bwd_reduce',)}


def train_shape_forward(torch, rng, dev, record):
    """K1 and K5 at the training step's encoder shape (H=1024 B=32 T=427
    bf16) beside one cuDNN layer's forward (the next redesign's
    yardstick)."""
    for cell in ('LSTM', 'GRU'):
        bf16_forward_case(torch, rng, dev, record, cell, 32, 427, ENC_IN)


def bf16_forward_case(torch, rng, dev, record, cell, b, t, n_in, hid=1024):
    """K1 (cell 'LSTM') or K5 ('GRU') at (H, B, T) in bf16, beside one
    cuDNN layer's forward of input width n_in where given.  Free-running
    bf16 drifts
    over hundreds of steps (a one-ulp flip of h feeds every later step),
    so each step is held from the kernel's own carried state: ys to one
    bf16 ulp, the LSTM's cs to 1e-4; the free-running error is
    reported."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    dt = torch.bfloat16
    gates = 4 if cell == 'LSTM' else 3
    k = 1.0 / hid ** 0.5
    xp = randn(torch, rng, dev, (t, b, gates * hid)).to(dt)
    w = torch.as_tensor(rng.uniform(-k, k, (gates * hid, hid))
                        .astype(np.float32), device=dev).to(dt)
    h0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                         device=dev)
    if cell == 'LSTM':
        c0 = torch.as_tensor(rng.randn(b, hid).astype(np.float32) * 0.5,
                             device=dev)
        inputs = (xp, w, h0, c0)
        kernel = lambda: K1.lstm_recurrence(*inputs)  # noqa: E731
        plain = lambda: K1.lstm_recurrence_plain(*inputs)  # noqa: E731
        ys, cs, hT = kernel()
        outs = (ys, cs, hT)
        step_ys, step_cs = lstm_steps_plain(torch, K1, xp, w, h0, c0, ys, cs)
        steps = [_close(ys, step_ys, 1e-2, 2.0 ** -7),
                 _close(cs, step_cs, 1e-4, 1e-4)]
        run_err = _close(ys, plain()[0], 0.0, 0.0)[1]
    else:
        b_hh = torch.as_tensor(rng.randn(gates * hid).astype(np.float32)
                               * 0.1, device=dev)
        inputs = (xp, w, b_hh, h0)
        kernel = lambda: K5.gru_recurrence(*inputs)[0]  # noqa: E731
        plain = lambda: K5.gru_recurrence_plain(*inputs)  # noqa: E731
        ys = kernel()
        outs = (ys,)
        h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b, hid)
        step_ys = K5.gru_recurrence_plain(
            xp.reshape(1, t * b, gates * hid), w, b_hh,
            h_prev).reshape(ys.shape)
        steps = [_close(ys, step_ys, 1e-2, 2.0 ** -7)]
        run_err = _close(ys, plain(), 0.0, 0.0)[1]
    torch.cuda.synchronize()
    ms, pms = time_pair(torch, plain, kernel)
    b_ms, b_by = bound(nbytes(*inputs, *outs),
                       2 * t * b * gates * hid * hid, 'bf16')
    label = 'K1 lstm_fwd' if cell == 'LSTM' else 'K5 gru_fwd'
    case = {'kernel': label, 'H': hid, 'B': b, 'T': t, 'dtype': 'bfloat16',
            'shape': 'training', 'plan': fwd_plan(xp, gates),
            'step_max_abs': [e for _, e in steps],
            'run_max_abs': run_err, 'ms': ms, 'plain_ms': pms,
            'bound_ms': b_ms, 'bound_by': b_by,
            'tol': 'per step ys atol 1e-2 rtol 2^-7'
                   + (', cs 1e-4' if cell == 'LSTM' else '')}
    if n_in:
        case.update(layer_times(torch, cell, hid, b, t, dt, False, n_in))
    emit(case)
    require(all(ok for ok, _ in steps), f'{label} disagrees: {case}')
    record('lstm_fwd' if cell == 'LSTM' else 'gru_fwd',
           max(e for _, e in steps))


def gru_bwd_case(torch, rng, dev, record, hid, b, t, dt, n_in=None):
    """K6 against its plain version at (H, B, T, dtype), timed, split into
    its two launches by the profiler; the E6D2 encoder's (H=1024, T=427)
    also beside one cuDNN layer, and given the layer's input width n_in
    beside one of that width."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    fp32 = torch.float32

    def t_(*shape, scale=1.0, dtype=fp32):
        return randn(torch, rng, dev, shape, scale).to(dtype)

    k = 1.0 / hid ** 0.5
    xp = t_(t, b, 3 * hid, dtype=dt)
    w = torch.as_tensor(rng.uniform(-k, k, (3 * hid, hid))
                        .astype(np.float32), device=dev).to(dt)
    b_hh = t_(3 * hid, scale=0.1)
    h0 = t_(b, hid, scale=0.5)
    ys, _ = K5.gru_recurrence(xp, w, b_hh, h0)
    dys = t_(t, b, hid, dtype=dt)
    dhT = t_(b, hid)
    args = (xp, w, b_hh, h0, ys, dys, dhT)
    out = K5.gru_recurrence_bwd(*args)
    ref = K5.gru_recurrence_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [_rel(torch, a, r) for a, r in zip(out, ref)]
    tol = 1e-4 if dt == fp32 else 2e-2
    case = {'kernel': 'K6 gru_bwd', 'H': hid, 'B': b, 'T': t,
            'dtype': str(dt).split('.')[-1], 'dgx_rel': errs[0],
            'dgh_rel': errs[1], 'dh0_rel': errs[2],
            'tol': f'max|d| / max(1, max|ref|) <= {tol}'}
    main = (hid, t) == (1024, 427)
    ms, pms = time_pair(torch, lambda: K5.gru_recurrence_bwd_plain(*args),
                        lambda: K5.gru_recurrence_bwd(*args))
    case.update(ms=ms, plain_ms=pms)
    # the gate remat and the dh product: 2 x 2·T·B·3H·H
    bounds = bound(nbytes(xp, w, b_hh, h0, ys, dys, dhT, *out),
                   12 * t * b * hid * hid, kind_of(torch, xp))
    case.update(bound_ms=bounds[0], bound_by=bounds[1])
    case.update(kernel_split_ms(
        torch, lambda: K5.gru_recurrence_bwd(*args), BWD_PARTS))
    if main:
        case.update(layer_times(torch, 'GRU', hid, b, t, dt, True))
    if n_in:
        case.update(layer_times(torch, 'GRU', hid, b, t, dt, True, n_in))
    emit(case)
    require(max(errs) <= tol, f'K6 disagrees: {case}')
    record('gru_bwd', max(errs), ms if main else None, pms, bounds,
           case.get('library_ms'))


def train_kernels(torch, rng, dev, record):
    """K4, K7/K8 and K9/K10 against their plain versions at the E6D2
    training step's shapes (B=32, 16 s: encoder T=427/214, prediction net
    T=U+1=65, joint J=640, V=2048)."""
    import dataclasses

    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import joint_lse_plan as JP
    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    bf16, fp32 = torch.bfloat16, torch.float32

    def t_(*shape, scale=1.0, dtype=fp32):
        return randn(torch, rng, dev, shape, scale).to(dtype)

    # K4 — LSTM backward: encoder layer 0 in bf16 (the training dtype), a
    # shorter encoder layer in fp32, the prediction net in bf16
    for hid, b, t, dt in ((1024, 32, 427, bf16), (1024, 32, 64, fp32),
                          (256, 32, 65, bf16)):
        lstm_bwd_case(torch, rng, dev, record, hid, b, t, dt)

    # K6 — GRU backward: encoder layer 0 in bf16 (the training dtype), a
    # shorter encoder layer in fp32, and odd small shapes
    for hid, b, t, dt in ((1024, 32, 427, bf16), (1024, 32, 64, fp32),
                          (1030, 11, 3, fp32), (40, 5, 7, bf16)):
        gru_bwd_case(torch, rng, dev, record, hid, b, t, dt)

    # K7 / K8 — fused joint: the E6D2 step in bf16, and U+1 = 300 (past the
    # TPU kernel's U envelope)
    for b, t, u1, dt in ((32, 214, 65, bf16), (2, 50, 300, bf16)):
        j, v = 640, 2048
        f, g = t_(b, t, j, dtype=dt), t_(b, u1, j, dtype=dt)
        w_t = t_(j, v, scale=j ** -0.5)
        bias = t_(v, scale=0.1)
        labels = torch.as_tensor(rng.randint(4, v, (b, u1 - 1))
                                 .astype(np.int32), device=dev)
        d_b, d_l = t_(b, t, u1, scale=0.1), t_(b, t, u1 - 1, scale=0.1)
        wt_e = w_t.to(dt).contiguous()
        blank_lp, label_lp, lse = KJ.joint_lse_fwd(f, g, wt_e, bias, labels,
                                                   0)
        grads = KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse, d_b, d_l)
        leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
        ref = KJ.fused_joint_lse_plain(*leaves, labels, 0)
        ref_g = torch.autograd.grad(ref, leaves, (d_b, d_l),
                                    retain_graph=True)
        torch.cuda.synchronize()
        fwd_err = max(_rel(torch, blank_lp, ref[0]),
                      _rel(torch, label_lp, ref[1]))
        bwd_errs = [_rel(torch, a, r) for a, r in zip(grads, ref_g)]
        case = {'kernel': 'K7/K8 joint_lse', 'B': b, 'T': t, 'U1': u1,
                'J': j, 'V': v, 'dtype': str(dt).split('.')[-1],
                'fwd_rel': fwd_err, 'df_rel': bwd_errs[0],
                'dg_rel': bwd_errs[1], 'dw_rel': bwd_errs[2],
                'dbias_rel': bwd_errs[3],
                'tol': 'lp 1e-4, grads 2e-2 (bf16 dlogits), of max(1, max|ref|)'}
        main = u1 == 65
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        case['plan'] = dataclasses.asdict(JP.bwd_plan(b, t, u1, j, v, sms))
        case['fwd_plan'] = dataclasses.asdict(JP.fwd_plan(b, t, u1, j, v,
                                                          sms))
        case['bwd_parts_ms'] = kernel_split_ms(
            torch, lambda: KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse,
                                            d_b, d_l), K8_PARTS)
        case['fwd_parts_ms'] = kernel_split_ms(
            torch, lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0),
            K7_PARTS)
        if main:
            ms, pms = time_pair(
                torch, lambda: KJ.fused_joint_lse_plain(f, g, w_t, bias,
                                                        labels, 0),
                lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0))
            bms, bpms = time_pair(
                torch, lambda: torch.autograd.grad(ref, leaves, (d_b, d_l),
                                                   retain_graph=True),
                lambda: KJ.joint_lse_bwd(f, g, wt_e, bias, labels, 0, lse,
                                         d_b, d_l))
            # the same forward with h staged through the slab scratch
            staged = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0, True)
            st_ms, _ = time_pair(
                torch, lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0),
                lambda: KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0, True))
            case.update(fwd_ms=ms, fwd_plain_ms=pms, bwd_ms=bms,
                        bwd_plain_ms=bpms, fwd_staged_ms=st_ms,
                        fwd_staged_parts_ms=kernel_split_ms(
                            torch, lambda: KJ.joint_lse_fwd(
                                f, g, wt_e, bias, labels, 0, True),
                            K7_PARTS),
                        fwd_staged_equal=all(torch.equal(a, c) for a, c in
                                             zip(staged, (blank_lp,
                                                          label_lp, lse))))
            require(case['fwd_staged_equal'],
                    'K7 staged through the scratch differs from resident')
        lattice_ops = 2 * b * t * u1 * j * v
        fwd_bound = bound(nbytes(f, g, wt_e, bias, labels, blank_lp,
                                 label_lp, lse), lattice_ops,
                          kind_of(torch, f))
        bwd_bound = bound(nbytes(f, g, wt_e, bias, labels, lse, d_b, d_l,
                                 *grads), 3 * lattice_ops, kind_of(torch, f))
        case.update(fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                    bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
        emit(case)
        require(fwd_err <= 1e-4 and max(bwd_errs) <= 2e-2,
                f'K7/K8 disagree: {case}')
        record('joint_lse_fwd', fwd_err, case.get('fwd_ms'),
               case.get('fwd_plain_ms'), fwd_bound)
        record('joint_lse_bwd', max(bwd_errs), case.get('bwd_ms'),
               case.get('bwd_plain_ms'), bwd_bound)
        del ref, ref_g, leaves

    k7_cases(torch, rng, dev, record)
    fp32_joint_cases(torch, rng, dev, record)

    # K9 / K10 — the lattice of the E6D2 step
    b, t, u1 = 32, 214, 65
    logits = torch.as_tensor(rng.randn(b, t, u1, 2).astype(np.float32),
                             device=dev)
    lp = logits - torch.logsumexp(logits, -1, keepdim=True)
    blank, label = lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous()
    xlen = torch.as_tensor(rng.randint(200, t + 1, b).astype(np.int32),
                           device=dev)
    ylen = torch.as_tensor(rng.randint(40, u1, b).astype(np.int32),
                           device=dev)
    alpha, logz = KL.lattice_alpha(blank, label, xlen, ylen)
    gb, gl = KL.lattice_beta_grad(blank, label, alpha, logz, xlen, ylen)
    # the plain chain in fp64: in fp32 its own occupancies are ~2e-4 off
    # here, over the tolerance, where K9 and K10 (fp64 chains) are ~1e-5 off
    wide = (blank.double(), label.double())
    r_alpha, r_logz = PL.lattice_alpha_plain(*wide, xlen, ylen)
    r_gb, r_gl = PL.lattice_beta_grad_plain(*wide, r_alpha, r_logz, xlen,
                                            ylen)
    torch.cuda.synchronize()
    logz_err = _rel(torch, logz, r_logz)
    occ_err = max(float((gb - r_gb).abs().max()),
                  float((gl - r_gl).abs().max()))
    occ_tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
    case = {'kernel': 'K9/K10 lattice', 'B': b, 'T': t, 'U1': u1,
            'logz_rel': logz_err, 'occupancy_max_abs': occ_err,
            'tol': f'logz 1e-5 of max(1, |logz|); occupancy {occ_tol:.2e} '
                   '(1e-6 |logZ|), of the plain chain in fp64'}
    emit(case)
    require(logz_err <= 1e-5 and occ_err <= occ_tol,
            f'K9/K10 disagree: {case}')
    cases = [(blank, label, xlen, ylen)] + lattice_cases(torch, dev)
    k9_cases(torch, record, cases)
    k10_cases(torch, record, [
        (*c, *KL.lattice_alpha(*c)) for c in cases])


def lattice_cases(torch, dev):
    """Seeded blank / label log-probs and lengths on the card at U+1 = 1,
    7, 300, 1100 and 2100 (the plan's geometries of one, two, four and
    eight columns a lane), T = 1 and an empty utterance (xlen = 0)."""
    rng = np.random.RandomState(10)
    cases = []
    for b, t, u1, edge in ((4, 9, 1, 'full'), (3, 6, 7, 'ragged'),
                           (2, 3, 300, 'ragged'), (2, 6, 1100, 'full'),
                           (3, 1, 65, 'ragged'), (3, 20, 65, 'xlen0'),
                           (1, 2, 2100, 'full')):
        logits = torch.as_tensor(rng.randn(b, t, u1, 2).astype(np.float32),
                                 device=dev)
        lp = logits - torch.logsumexp(logits, -1, keepdim=True)
        xlen = np.full(b, t, np.int32)
        ylen = np.full(b, u1 - 1, np.int32)
        if edge == 'ragged':
            xlen = rng.randint(max(1, t - 3), t + 1, b).astype(np.int32)
            ylen = rng.randint(0, u1, b).astype(np.int32)
        elif edge == 'xlen0':
            xlen[0], ylen[0] = 0, 0
        blank, label = lp[..., 0].contiguous(), lp[:, :, :-1, 1].contiguous()
        cases.append((blank, label,
                      *(torch.as_tensor(x, device=dev) for x in (xlen,
                                                                  ylen))))
    return cases


def k9_cases(torch, record, cases):
    """K9 (one register-wavefront launch, plan ops/rnnt_loss_kernel.py
    beta_plan) at the E6D2 step (the first case: timed, with its device ms
    by torch.profiler) and at lattice_cases' geometries: alpha on the cells
    t <= xlen, u <= ylen and logZ within max(1e-5, 1e-6 |logZ|) of the
    plain version run in fp64 (the fp32 plain version's own error beside
    it), logZ the stored alpha[xlen, ylen] bit for bit, the same bits on a
    second call, one kernel launch per call and no memory past what the
    caching allocator gives alpha and logz (alloc_bytes)."""
    import dataclasses

    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    for i, (blank, label, xlen, ylen) in enumerate(cases):
        b, t, u1 = blank.shape
        args = (blank, label, xlen, ylen)
        outputs = alloc_bytes(torch, (b, t + 1, u1), (b,))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        alpha, logz = KL.lattice_alpha(*args)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        again = KL.lattice_alpha(*args)
        wide = (blank.double(), label.double(), xlen, ylen)
        r_alpha, r_logz = PL.lattice_alpha_plain(*wide)
        p_alpha, p_logz = PL.lattice_alpha_plain(*args)
        valid = (torch.arange(t + 1, device=blank.device)[None, :, None]
                 <= xlen.long()[:, None, None]) \
            & (torch.arange(u1, device=blank.device)[None, None, :]
               <= ylen.long()[:, None, None])

        def err(a, z):
            return max(float((a.double() - r_alpha)[valid].abs().max()),
                       float((z.double() - r_logz).abs().max()))
        tol = max(1e-5, 1e-6 * float(r_logz.abs().max()))
        idx = torch.arange(b, device=blank.device)
        prof = _profiled_us(torch, lambda: KL.lattice_alpha(*args), 5)
        case = {'kernel': 'K9 lattice_alpha', 'B': b, 'T': t, 'U1': u1,
                'plan': dataclasses.asdict(KL.beta_plan(u1)),
                'xlen_min': int(xlen.min()), 'ylen_min': int(ylen.min()),
                'max_abs_err': err(alpha, logz),
                'plain_fp32_max_abs_err': err(p_alpha, p_logz),
                'tol': f'alpha (t <= xlen, u <= ylen) and logZ {tol:.2e} '
                       '(max(1e-5, 1e-6 |logZ|)) of the plain version in '
                       'fp64',
                'fp64_reference': r_alpha.dtype == r_logz.dtype
                == torch.float64,
                'logz_is_alpha': torch.equal(
                    logz, alpha[idx, xlen.long(), ylen.long()]),
                'bit_stable': torch.equal(alpha, again[0])
                and torch.equal(logz, again[1]),
                'extra_bytes': extra, 'output_bytes': outputs,
                'profiled_launches_per_call':
                    sum(c for _, c in prof.values()) / 5,
                'profiled_kernels': sorted(prof)}
        bounds = None
        if i == 0:
            # the cells this data needs: t < xlen, u <= ylen (fp32 in and
            # out)
            cells = int((xlen.long() * (ylen.long() + 1)).sum())
            bounds = bound(cells * 4 * 3 + nbytes(xlen, ylen, logz),
                           cells * 10, 'fp32')
            ms, pms = time_pair(torch, lambda: PL.lattice_alpha_plain(*args),
                                lambda: KL.lattice_alpha(*args))
            dms, _ = device_ms_per_launch(
                torch, lambda: KL.lattice_alpha(*args),
                'lattice_alpha_kernel')
            case.update(ms=ms, plain_ms=pms, device_ms=dms,
                        bound_ms=bounds[0], bound_by=bounds[1])
        emit(case)
        # a profiled run may lose records (PERF.md §7): fewer than one a
        # call is that, more than one is a second launch
        require(case['max_abs_err'] <= tol and case['fp64_reference']
                and case['logz_is_alpha'] and case['bit_stable']
                and extra <= outputs
                and case['profiled_launches_per_call'] <= 1
                and all('lattice_alpha_kernel' in k for k in prof),
                f'K9 disagrees: {case}')
        record('lattice_alpha', case['max_abs_err'], case.get('ms'),
               case.get('plain_ms'), bounds, None, case.get('device_ms'))


def alloc_bytes(torch, *shapes):
    """The bytes that the caching allocator hands fp32 card tensors of
    these shapes, allocated in turn (its rounding: 512-byte multiples, and
    a whole 2 MiB block where less than 1 MiB of it would be left), read
    the way k9_cases reads a kernel's; a best-fit request of the same
    sizes right after gets the same blocks back."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    held = [torch.empty(s, device='cuda') for s in shapes]
    n = torch.cuda.max_memory_allocated() - base
    del held
    return n


def k10_cases(torch, record, cases, wide=False):
    """K10 (one register-wavefront launch, plan ops/rnnt_loss_kernel.py
    beta_plan) against its plain version given the same alpha and logZ
    (K9's), at the E6D2 step (the first case: timed, with its device ms by
    torch.profiler) and at lattice_cases' geometries: occupancies to
    max(1e-5, 1e-6 |logZ|), the same bits on a second call, one kernel
    launch per call on the card.  wide: the plain version run in fp64 on
    the same inputs (over the raw fine-tune's 1597 frames its fp32 beta
    chain drifts past the tolerance, 3.8e-3, where K10 carries beta in
    fp64), the fp32 plain version's own error beside it."""
    import dataclasses

    from edgedict_tpu_torch.ops import rnnt_loss as PL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    for i, (blank, label, xlen, ylen, alpha, logz) in enumerate(cases):
        b, t, u1 = blank.shape
        args = (blank, label, alpha, logz, xlen, ylen)
        gb, gl = KL.lattice_beta_grad(*args)
        again = KL.lattice_beta_grad(*args)
        r_gb, r_gl = PL.lattice_beta_grad_plain(*args)
        torch.cuda.synchronize()

        def occ_err(a, c):
            return max(float((a[0] - c[0]).abs().max()),
                       float((a[1] - c[1]).abs().max()) if gl.numel()
                       else 0.0)
        err = occ_err((gb, gl), (r_gb, r_gl))
        if wide:
            plain_fp32_err = err
            w_gb, w_gl = PL.lattice_beta_grad_plain(
                *(x.double() for x in args[:4]), xlen, ylen)
            err = occ_err((gb.double(), gl.double()), (w_gb, w_gl))
        tol = max(1e-5, 1e-6 * float(logz.abs().max()))
        prof = _profiled_us(torch, lambda: KL.lattice_beta_grad(*args), 5)
        case = {'kernel': 'K10 lattice_beta_grad', 'B': b, 'T': t, 'U1': u1,
                'plan': dataclasses.asdict(KL.beta_plan(u1)),
                'xlen_min': int(xlen.min()), 'occupancy_max_abs': err,
                'tol': f'occupancy {tol:.2e} (max(1e-5, 1e-6 |logZ|)), '
                       'plain given the same alpha and logZ',
                'bit_stable': torch.equal(gb, again[0])
                and torch.equal(gl, again[1]),
                'profiled_launches_per_call':
                    sum(c for _, c in prof.values()) / 5,
                'profiled_kernels': sorted(prof)}
        if wide:
            case.update(tol=case['tol'] + ', the plain version in fp64',
                        plain_fp32_max_abs_err=plain_fp32_err)
        bounds = None
        if i == 0:
            # the cells this data needs: t < xlen, u <= ylen; blank, label,
            # alpha in, gb, gl out (fp32)
            cells = int((xlen.long() * (ylen.long() + 1)).sum())
            bounds = bound(cells * 4 * 5 + nbytes(xlen, ylen, logz),
                           cells * 20, 'fp32')
            ms, pms = time_pair(torch,
                                lambda: PL.lattice_beta_grad_plain(*args),
                                lambda: KL.lattice_beta_grad(*args))
            dms, _ = device_ms_per_launch(
                torch, lambda: KL.lattice_beta_grad(*args),
                'lattice_beta_grad_kernel')
            case.update(ms=ms, plain_ms=pms, device_ms=dms,
                        bound_ms=bounds[0], bound_by=bounds[1])
        emit(case)
        # a profiled run may lose records (PERF.md §7): fewer than one a
        # call is that, more than one is a second launch
        require(err <= tol and case['bit_stable']
                and case['profiled_launches_per_call'] <= 1
                and all('lattice_beta_grad_kernel' in k for k in prof),
                f'K10 disagrees: {case}')
        record('lattice_beta_grad', err, case.get('ms'),
               case.get('plain_ms'), bounds, None, case.get('device_ms'))


def k7_cases(torch, rng, dev, record):
    """K7 against its plain version at the shapes beside the E6D2 step:
    ragged B=33, U+1 = 1, 300 and 1100, J and V padded to multiples of 16
    (600, 2000), a J too wide for h to stay resident (768), and fp32 on CUDA
    cores; labels equal to blank included, and the same bits on a second
    call.  The blank / label log-probs and the logsumexp to 1e-4 of
    max(1, |ref|)."""
    import dataclasses

    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import joint_lse_plan as JP
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, t, u1, j, v, dt in ((33, 214, 65, 640, 2048, torch.bfloat16),
                               (4, 50, 1, 640, 2048, torch.bfloat16),
                               (2, 50, 300, 640, 2048, torch.bfloat16),
                               (2, 6, 1100, 640, 2048, torch.bfloat16),
                               (2, 9, 33, 600, 2000, torch.bfloat16),
                               (2, 6, 33, 768, 400, torch.bfloat16),
                               (2, 20, 65, 640, 2048, torch.float32)):
        def t_(*shape, scale=1.0):
            return torch.as_tensor((rng.randn(*shape) * scale)
                                   .astype(np.float32), device=dev)
        f, g = t_(b, t, j).to(dt), t_(b, u1, j).to(dt)
        w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
        labels = torch.as_tensor(rng.randint(0, v, (b, u1 - 1))
                                 .astype(np.int32), device=dev)
        labels[:, ::3] = 0
        wt_e = w_t.to(dt)
        out = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
        again = KJ.joint_lse_fwd(f, g, wt_e, bias, labels, 0)
        ref = KJ.fused_joint_lse_plain(f, g, w_t, bias, labels, 0)
        h = torch.tanh(f.float()[:, :, None] + g.float()[:, None])
        lse = torch.logsumexp(h.to(dt).float() @ wt_e.float() + bias, -1)
        del h
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) if a.numel() else 0.0
                for a, r in zip(out, (*ref, lse))]
        stable = all(torch.equal(a, c) for a, c in zip(out, again))
        case = {'kernel': 'K7 joint_lse_fwd', 'B': b, 'T': t, 'U1': u1,
                'J': j, 'V': v, 'dtype': str(dt).split('.')[-1],
                'blank_rel': errs[0], 'label_rel': errs[1],
                'lse_rel': errs[2],
                'bit_stable': stable,
                'tol': 'lp and lse 1e-4 of max(1, max|ref|)'}
        if dt == torch.bfloat16:
            jp, vp = -(-j // 16) * 16, -(-v // 16) * 16
            case['plan'] = dataclasses.asdict(JP.fwd_plan(b, t, u1, jp, vp,
                                                          sms))
        emit(case)
        require(max(errs) <= 1e-4 and stable, f'K7 disagrees: {case}')
        record('joint_lse_fwd', max(errs))
        del out, again, ref, lse


# the fp32 joint's main-path lattices (J 640, V 2048): (B, T, U+1, K8 too)
# — E6D2's trainer eval and --bf16 false step, the raw fine-tune's eval
FP32_JOINT = ((32, 214, 65, True), (4, 1437, 33, False))


def fp32_joint_cases(torch, rng, dev, record):
    """K7 in fp32 (FFMA lattice tiles) at both evals' lattices and K8 in
    fp32 at the E6D2 step's, each against the plain joint over the whole
    lattice (its logits fit the card), timed in turns with its bound and
    plan: log-probs and lse to 1e-4 of max(1, max|ref|), gradients to 1e-4,
    each output the same bits on a second call."""
    import dataclasses

    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import joint_lse_plan as JP
    j, v = 640, 2048
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def t_(*shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev)
    for b, t, u1, backward in FP32_JOINT:
        f, g = t_(b, t, j), t_(b, u1, j)
        w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
        labels = torch.as_tensor(rng.randint(4, v, (b, u1 - 1))
                                 .astype(np.int32), device=dev)
        labels[:, ::3] = 0
        out = KJ.joint_lse_fwd(f, g, w_t, bias, labels, 0)
        again = KJ.joint_lse_fwd(f, g, w_t, bias, labels, 0)
        with torch.no_grad():
            ref = KJ.joint_lse_fwd_plain(f, g, w_t, bias, labels, 0)
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) for a, r in zip(out, ref)]
        del ref
        plain = lambda: KJ.joint_lse_fwd_plain(  # noqa: E731
            f, g, w_t, bias, labels, 0)
        with torch.no_grad():
            ms, pms = time_pair(torch, plain, lambda: KJ.joint_lse_fwd(
                f, g, w_t, bias, labels, 0), 10)
        ops = 2 * b * t * u1 * j * v
        fwd_bound = bound(nbytes(f, g, w_t, bias, labels, *out), ops, 'fp32')
        case = {'kernel': 'K7 joint_lse_fwd', 'B': b, 'T': t, 'U1': u1,
                'J': j, 'V': v, 'dtype': 'float32', 'blank_rel': errs[0],
                'label_rel': errs[1], 'lse_rel': errs[2],
                'bit_stable': all(torch.equal(a, c)
                                  for a, c in zip(out, again)),
                'ms': ms, 'plain_ms': pms,
                'plain': 'joint_lse_fwd_plain over the whole lattice',
                'bound_ms': fwd_bound[0], 'bound_by': fwd_bound[1],
                'bound_share': fwd_bound[0] / ms,
                'plan': dataclasses.asdict(JP.fwd_plan(b, t, u1, j, v, sms,
                                                       elem=4)),
                'tol': 'lp and lse 1e-4 of max(1, max|ref|)'}
        emit(case)
        require(max(errs) <= 1e-4 and case['bit_stable'],
                f'fp32 K7 disagrees: {case}')
        record('joint_lse_fwd', max(errs))
        del out, again
        if not backward:
            continue
        lse = KJ.joint_lse_fwd(f, g, w_t, bias, labels, 0)[2]
        d_b, d_l = t_(b, t, u1, scale=0.1), t_(b, t, u1 - 1, scale=0.1)
        grads = KJ.joint_lse_bwd(f, g, w_t, bias, labels, 0, lse, d_b, d_l)
        again = KJ.joint_lse_bwd(f, g, w_t, bias, labels, 0, lse, d_b, d_l)
        leaves = [x.clone().requires_grad_() for x in (f, g, w_t, bias)]
        ref = KJ.fused_joint_lse_plain(*leaves, labels, 0)
        ref_g = torch.autograd.grad(ref, leaves, (d_b, d_l),
                                    retain_graph=True)
        torch.cuda.synchronize()
        errs = [_rel(torch, a, r) for a, r in zip(grads, ref_g)]
        del ref_g
        bms, bpms = time_pair(
            torch, lambda: torch.autograd.grad(ref, leaves, (d_b, d_l),
                                               retain_graph=True),
            lambda: KJ.joint_lse_bwd(f, g, w_t, bias, labels, 0, lse, d_b,
                                     d_l), 5)
        bwd_bound = bound(nbytes(f, g, w_t, bias, labels, lse, d_b, d_l,
                                 *grads), 3 * ops, 'fp32')
        case = {'kernel': 'K8 joint_lse_bwd', 'B': b, 'T': t, 'U1': u1,
                'J': j, 'V': v, 'dtype': 'float32', 'df_rel': errs[0],
                'dg_rel': errs[1], 'dw_rel': errs[2], 'dbias_rel': errs[3],
                'bit_stable': all(torch.equal(a, c)
                                  for a, c in zip(grads, again)),
                'ms': bms, 'plain_ms': bpms,
                'plain': 'autograd through fused_joint_lse_plain, its '
                         'forward graph kept',
                'bound_ms': bwd_bound[0], 'bound_by': bwd_bound[1],
                'bound_share': bwd_bound[0] / bms,
                'parts_ms': kernel_split_ms(
                    torch, lambda: KJ.joint_lse_bwd(
                        f, g, w_t, bias, labels, 0, lse, d_b, d_l),
                    K8_PARTS, n=2),
                'plan': dataclasses.asdict(JP.bwd_plan(b, t, u1, j, v, sms,
                                                       4)),
                'tol': 'grads 1e-4 of max(1, max|ref|)'}
        emit(case)
        require(max(errs) <= 1e-4 and case['bit_stable'],
                f'fp32 K8 disagrees: {case}')
        record('joint_lse_bwd', max(errs))
        del ref, leaves, grads, again


def quant_layer_times(torch, cell, hid, b, t, n_in=ENC_IN):
    """K12 / K13's library yardstick: dequantize W_ih and W_hh (int8 →
    fp32) and one cuDNN nn.LSTM / nn.GRU layer forward with them (input
    (T, B, n_in), fp32), beside the port's own int8 layer (ops/quant.py:
    K11's x_proj, then K12 / K13) from the same int8 weights, both timed
    as layer_times times K1/K5's (median of 10).
    → {'library_ms', 'layer_ms', 'cudnn'} ({} untimed())."""
    from torch.func import functional_call
    if STATE.get('untimed'):
        return {}

    from edgedict_tpu_torch.ops import quant as Q
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(hid + b + t)
    xs = torch.randn(t, b, n_in, generator=gen).to(dev)
    mod = getattr(torch.nn, cell)(n_in, hid).to(dev)
    qrnn = Q.QuantRNN(mod).to(dev)
    params = qrnn.layer(0)
    h0 = torch.zeros(b, hid, device=dev)
    layer = Q.gru_layer_tm_q if cell == 'GRU' else Q.lstm_layer_tm_q
    state = h0 if cell == 'GRU' else (h0, h0)

    def library():
        with torch.no_grad():
            functional_call(mod, {
                'weight_ih_l0': Q.dequantize(qrnn.w_ih_q, qrnn.w_ih_scale,
                                             torch.float32),
                'weight_hh_l0': Q.dequantize(qrnn.w_hh_q, qrnn.w_hh_scale,
                                             torch.float32),
                'bias_ih_l0': qrnn.b_ih, 'bias_hh_l0': qrnn.b_hh}, (xs,))

    def port():
        with torch.no_grad():
            layer(params, xs, state)
    return {'cudnn': torch.backends.cudnn.version(),
            'library_ms': _median_ms(torch, library, iters=10, warmup=2),
            'layer_ms': _median_ms(torch, port, iters=10, warmup=2)}


# K12's and K13's __global__ names (csrc/rnn_fwd.cu); neither holds the other
Q_KERNELS = {'lstm_fwd_q': 'recur_fwd_q_kernel',
             'gru_fwd_q': 'recur_fwd_gru_q_kernel'}


def quant_matmul_case(torch, rng, dev, record, r, k, n, dt):
    """K11 against its plain version at (R rows, K, N, dtype), timed beside
    dequantize + F.linear: fp32 to 1e-5 of max(1, |out|) (fp32 sums in
    another order); bf16 to 1e-2 (both round the same fp32 value to bf16:
    one ulp apart at most).  R <= 32 runs the matrix-vector kernel (kept
    as quant_matmul), more rows the tiled kernels (quant_matmul_tile).
    → the case."""
    from edgedict_tpu_torch.ops import quant as Q
    fp32, bf16 = torch.float32, torch.bfloat16

    def t_(*shape, scale=1.0, dtype=fp32):
        return randn(torch, rng, dev, shape, scale).to(dtype)

    x = t_(r, k, dtype=dt)
    q, sc = Q.quantize_int8(t_(n, k, scale=k ** -0.5))
    bias = t_(n, scale=0.1)
    out = Q.quant_matmul(x, q, sc, bias)
    ref = Q.quant_matmul_plain(x, q, sc, bias)
    torch.cuda.synchronize()
    rel = _rel(torch, out, ref)
    tol = 1e-5 if dt == fp32 else 1e-2
    ms, pms = time_pair(torch, lambda: Q.quant_matmul_plain(x, q, sc, bias),
                        lambda: Q.quant_matmul(x, q, sc, bias))
    lib = _median_ms(torch, lambda: torch.nn.functional.linear(
        x, Q.dequantize(q, sc, dt), bias.to(dt)))
    case = {'kernel': 'K11 quant_matmul', 'R': r, 'K': k, 'N': n,
            'dtype': str(dt).split('.')[-1], 'rel_err': rel,
            'tol': f'max|d| / max(1, max|ref|) <= {tol}', 'ms': ms,
            'plain_ms': pms, 'library_ms': lib}
    b_ms, b_by = bound(nbytes(x, q, sc, bias, out), 2 * r * k * n,
                       kind_of(torch, x))
    case.update(bound_ms=b_ms, bound_by=b_by)
    emit(case)
    require(rel <= tol, f'K11 disagrees: {case}')
    if r <= 32:
        main = (r, k, n, dt) == (2, 1024, 4096, fp32)
        record('quant_matmul', rel, ms if main else None, pms,
               (b_ms, b_by), lib)
    else:
        main = (r, k, n, dt) == (512, 1024, 4096, bf16)
        record('quant_matmul_tile', rel, ms if main else None, pms,
               (b_ms, b_by), lib)
    return case


def recurrence_case(torch, rng, dev, record, name, hid, b, t, dt,
                    n_in=None):
    """K5 ('gru_fwd'), K12 ('lstm_fwd_q') or K13 ('gru_fwd_q') against its
    plain version at (H, B, T, dtype): free-running to 1e-4 in fp32 and
    2e-2 in bf16, where one rounding flip of h feeds every later step; so
    bf16 is also held step by step from the kernel's own carried state: ys
    to one bf16 ulp (2^-7 of |ys|, or 1e-2), the LSTM's cs to 1e-4; K12 /
    K13 bit-stable, with their plan and device ms; given the layer's input
    width n_in, beside one cuDNN layer (K5) or dequantize + one cuDNN
    layer (K12 / K13) of that width."""
    from edgedict_tpu_torch.ops import gru_kernel as K5
    from edgedict_tpu_torch.ops import quant as Q
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    fp32 = torch.float32

    def t_(*shape, scale=1.0, dtype=fp32):
        return randn(torch, rng, dev, shape, scale).to(dtype)

    kw = 1.0 / hid ** 0.5
    gates = 4 if name == 'lstm_fwd_q' else 3
    xp = t_(t, b, gates * hid, dtype=dt)
    w = torch.as_tensor(rng.uniform(-kw, kw, (gates * hid, hid))
                        .astype(np.float32), device=dev)
    b_hh = t_(gates * hid, scale=0.1)
    h0 = t_(b, hid, scale=0.5)
    c0 = t_(b, hid, scale=0.5)
    if name == 'gru_fwd':
        w = w.to(dt)
        kernel = lambda: K5.gru_recurrence(  # noqa: E731
            xp, w, b_hh, h0)[0]
        plain = lambda: K5.gru_recurrence_plain(  # noqa: E731
            xp, w, b_hh, h0)
        w_eff, inputs = w, (xp, w, b_hh, h0)
    else:
        q, sc = Q.quantize_int8(w)
        w_eff = Q.dequantize(q, sc, dt)
        if name == 'gru_fwd_q':
            kernel = lambda: Q.gru_recurrence_q(  # noqa: E731
                xp, q, sc, b_hh, h0)
            plain = lambda: Q.gru_recurrence_q_plain(  # noqa: E731
                xp, q, sc, b_hh, h0)
            inputs = (xp, q, sc, b_hh, h0)
        else:
            kernel = lambda: Q.lstm_recurrence_q(  # noqa: E731
                xp, q, sc, h0, c0)
            plain = lambda: Q.lstm_recurrence_q_plain(  # noqa: E731
                xp, q, sc, h0, c0)
            inputs = (xp, q, sc, h0, c0)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    run_tol = 1e-4 if dt == fp32 else 2e-2
    step_tol = (1e-4, 1e-4) if dt == fp32 else (1e-2, 2.0 ** -7)
    if name == 'lstm_fwd_q':
        ys, cs, _ = out
        step_ys, step_cs = lstm_steps_plain(torch, K1, xp, w_eff, h0, c0,
                                            ys, cs)
        runs = [_close(a, r_, run_tol, run_tol)
                for a, r_ in zip(out, ref)]
        steps = [_close(ys, step_ys, *step_tol),
                 _close(cs, step_cs, 1e-4, 1e-4)]
    else:
        ys = out
        h_prev = torch.cat([h0[None], ys[:-1].float()]).reshape(t * b,
                                                                hid)
        step_ys = K5.gru_recurrence_plain(
            xp.reshape(1, t * b, gates * hid), w_eff, b_hh,
            h_prev).reshape(ys.shape)
        runs = [_close(ys, ref, run_tol, run_tol)]
        steps = [_close(ys, step_ys, *step_tol)]
    ok = all(c for c, _ in runs + steps)
    errs = [e for _, e in runs]
    steps = [e for _, e in steps]
    ms, pms = time_pair(torch, plain, kernel)
    b_ms, b_by = bound(nbytes(*inputs, *((out,) if name != 'lstm_fwd_q'
                                         else out)),
                       2 * t * b * gates * hid * hid, kind_of(torch, xp))
    label = {'gru_fwd': 'K5 gru_fwd', 'lstm_fwd_q': 'K12 lstm_fwd_q',
             'gru_fwd_q': 'K13 gru_fwd_q'}[name]
    case = {'kernel': label, 'H': hid, 'B': b, 'T': t,
            'dtype': str(dt).split('.')[-1], 'run_max_abs': max(errs),
            'step_max_abs': steps, 'ms': ms, 'plain_ms': pms,
            'bound_ms': b_ms, 'bound_by': b_by,
            'tol': f'run atol/rtol {run_tol}; per step ys atol '
                   f'{step_tol[0]} rtol {step_tol[1]:.3g}'
                   + (', cs 1e-4' if name == 'lstm_fwd_q' else '')}
    main = (hid, b, t, dt) == (1024, 1, 2, fp32)
    if name == 'gru_fwd':
        case['plan'] = fwd_plan(xp, 3)
    if name in ('lstm_fwd_q', 'gru_fwd_q'):
        # one persistent launch per call under the kernel's own name:
        # its plan, its device time by torch.profiler and the launches
        # the profiler recorded per call (it has lost records on the
        # card machine: PERF.md §7)
        case['plan'] = fwd_plan(xp, gates, quant=True)
        again = kernel()
        pairs = zip(out, again) if name == 'lstm_fwd_q' else \
            [(out, again)]
        case['bit_stable'] = all(torch.equal(a, c) for a, c in pairs)
        ok = ok and case['bit_stable']
        dms, n = device_ms_per_launch(torch, kernel, Q_KERNELS[name])
        case.update(device_ms=dms, profiled_launches_per_call=n / 5)
    if main and name == 'gru_fwd':
        case.update(layer_times(torch, 'GRU', hid, b, t, dt, False))
    if main and name in ('lstm_fwd_q', 'gru_fwd_q'):
        case.update(quant_layer_times(
            torch, 'GRU' if name == 'gru_fwd_q' else 'LSTM', hid, b, t))
    if n_in and name == 'gru_fwd':
        case.update(layer_times(torch, 'GRU', hid, b, t, dt, False, n_in))
    elif n_in:
        case.update(quant_layer_times(
            torch, 'GRU' if name == 'gru_fwd_q' else 'LSTM', hid, b, t,
            n_in))
    emit(case)
    require(ok, f'{label} disagrees: {case}')
    record(name, max(errs + steps), ms if main else None, pms,
           (b_ms, b_by), case.get('library_ms'), case.get('device_ms'))


def serving_kernels_q(torch, rng, dev, record):
    """K5 (GRU forward), K11 (int8-weight matmul), K12 / K13 (int8 LSTM /
    GRU recurrences) against their plain versions at E6D2's serving shapes
    (H=1024, B 1 and 64, T=2; K11 for every layer's x_proj and the final
    projection at R = T*B rows 2, 64, 128 and 512: one stream, the int8
    server's 64 streams after and before the time reduction, 256 streams),
    fp32 and bf16.  → K11's R=512 cases (its tiled kernels)."""
    fp32, bf16 = torch.float32, torch.bfloat16
    # K11 at R=2 (the matrix-vector kernel), R=64, 128 and 512 (the tiled
    # kernels; each R=512 case is kept in the kernels line's
    # quant_matmul_tile entry)
    tile_cases = []
    for (k, n), r, dt in [(kn, r, dt) for kn in ((240, 4096), (1024, 4096),
                                                 (1024, 640), (240, 3072),
                                                 (1024, 3072))
                          for r in (2, 64, 128, 512)
                          for dt in (fp32, bf16)]:
        case = quant_matmul_case(torch, rng, dev, record, r, k, n, dt)
        if r == 512:
            tile_cases.append({key: case[key] for key in (
                'R', 'K', 'N', 'dtype', 'ms', 'plain_ms', 'library_ms',
                'bound_ms', 'bound_by', 'rel_err')})

    # K5 / K12 / K13
    for name, hid, b, t, dt in [(nm, 1024, b, 2, dt)
                                for nm in ('gru_fwd', 'lstm_fwd_q',
                                           'gru_fwd_q')
                                for b in (1, 64) for dt in (fp32, bf16)] + [
                                    ('lstm_fwd_q', 1024, 1, 16, fp32),
                                    ('lstm_fwd_q', 1024, 1, 16, bf16),
                                    ('gru_fwd_q', 1024, 1, 16, fp32),
                                    ('gru_fwd_q', 1024, 1, 16, bf16),
                                    ('gru_fwd_q', 72, 9, 4, fp32),
                                    ('gru_fwd', 1024, 33, 2, bf16),
                                    ('gru_fwd', 1024, 256, 2, fp32)]:
        recurrence_case(torch, rng, dev, record, name, hid, b, t, dt)
    return tile_cases


def _e6d2(flagfile='flagfiles/E6D2.txt', vocab=2048):
    """(TransducerConfig at `vocab` ids, streaming FeatureConfig) of a
    bundled flagfile (E6D2's by default; None: the flags' own defaults)."""
    from edgedict_tpu_torch import config as C
    argv = [f'--flagfile={REPO}/{flagfile}'] if flagfile else []
    flags = C.parse_flags(C.add_model_flags(argparse.ArgumentParser()),
                          argv)
    feat = C.feature_config_from_flags(flags, pad_to_divisible=False)
    cfg = C.transducer_config_from_flags(flags, vocab, feat.input_size)
    return cfg, feat


def _counters():
    """{kernel name: the wrapper that counts its launches}."""
    from edgedict_tpu_torch.ops import (
        decode_kernel, features_kernel, gru_kernel, joint_lse_kernel, quant,
        rnn_kernel, rnnt_loss_kernel)
    return {'lstm_fwd': rnn_kernel.lstm_recurrence,
            'gru_fwd': gru_kernel.gru_recurrence,
            'quant_matmul': quant.quant_matmul,
            'lstm_fwd_q': quant.lstm_recurrence_q,
            'gru_fwd_q': quant.gru_recurrence_q,
            'mel_power': features_kernel.mel_power,
            'greedy_decode': decode_kernel.greedy_frame_loop,
            'lstm_bwd': rnn_kernel.lstm_recurrence_bwd,
            'gru_bwd': gru_kernel.gru_recurrence_bwd,
            'joint_lse_fwd': joint_lse_kernel.joint_lse_fwd,
            'joint_lse_bwd': joint_lse_kernel.joint_lse_bwd,
            'lattice_alpha': rnnt_loss_kernel.lattice_alpha,
            'lattice_beta_grad': rnnt_loss_kernel.lattice_beta_grad}


def _reset_launches():
    for fn in _counters().values():
        fn.launches = 0
    _counters()['quant_matmul'].tile_launches = 0


def _launches():
    """{kernel name: launches}; quant_matmul_tile counts K11's tiled
    launches (R > 32), which quant_matmul also counts."""
    counts = {name: fn.launches for name, fn in _counters().items()}
    counts['quant_matmul_tile'] = _counters()['quant_matmul'].tile_launches
    return counts


def _first_divergence(torch, model, cfg, feat, tok, audio, a, b):
    """Replay the CPU plain decode up to the first frame where the token
    sequences a and b differ; return (frame, top-2 logit gap there)."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.ops.decode_kernel import greedy_frame_loop_plain
    k = int(np.argmax(a[:len(b)] != b[:len(a)]))
    dec = S.StreamingDecoder(model, cfg, feat, tok, device='cpu')
    state, frame = dec._fresh, 0
    cache = dec.model.decode_cache
    for chunk in S._chunks(audio, dec.win_size, dec.hop_size):
        with torch.no_grad():
            x = torch.as_tensor(chunk[None].astype(np.float32))
            xs, _ = dec.pipeline(x, torch.tensor([len(chunk)]))
            enc, enc_state = T.encoder_apply(dec.model.encoder, cfg, xs,
                                             state.enc_state)
            for i in range(enc.shape[1]):
                fr = enc[:, i] @ dec.model.joint.w_enc.t()
                g = state.h_dec @ cache['w_dec_t'] + cache['b_joint']
                logits = torch.tanh(fr + g) @ cache['w_out_t'] \
                    + cache['b_out']
                if frame == k:
                    top = torch.topk(logits[0], 2).values
                    return k, float(top[0] - top[1])
                _, _, h_dec, hs, cs = greedy_frame_loop_plain(
                    cache, fr[None], state.h_dec, *state.dec_state,
                    int(cfg.blank), 3)
                state = S.StreamState(state.enc_state, (hs, cs), h_dec)
                frame += 1
            state = S.StreamState(enc_state, state.dec_state, state.h_dec)
    return k, float('nan')


def _decode(model, cfg, feat, tok, audio, device, dtype=None, quantize=None,
            count=None, shapes=None):
    """A warm-up decode_wav, then the measured one → (decoder, tokens);
    with `count`, the launch counts of the measured decode alone go to
    STATE['launches_' + count]; with `shapes` (a context of
    _recorded_shapes), its kernels' shapes too."""
    from edgedict_tpu_torch import stream as S
    dec = S.StreamingDecoder(model, cfg, feat, tok, device=device,
                             compute_dtype=dtype, quantize=quantize)
    dec.decode_wav(audio)                    # warm-up
    dec.reset_profile()
    if count:
        _reset_launches()
    with shapes or contextlib.nullcontext():
        dec.decode_wav(audio)
    if count:
        STATE['launches_' + count] = _launches()
        STATE['chunks_' + count] = len(dec.elapsed)
    return dec, np.concatenate(dec.emitted)


def _agreement(a, b):
    return float((a == b).mean()) if a.shape == b.shape else 0.0


def _bf16_encoder_diff(torch, cfg, dec32, dec16, audio):
    """Encoder output, bf16 encoder against fp32, over the whole
    utterance as one layer-major block → (max |diff|, max |fp32 out|)."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.models import transducer as T
    with torch.no_grad():
        chunks = torch.as_tensor(S._chunks(audio, dec32.win_size,
                                           dec32.hop_size), device='cuda')
        lens = torch.full((len(chunks),), chunks.shape[1], device='cuda')
        xs, _ = dec32.pipeline(chunks, lens)
        xs = xs.reshape(1, -1, xs.shape[-1])
        e32, _ = T.encoder_apply(dec32.model.encoder, cfg, xs)
        e16, _ = T.encoder_apply(dec16.model.encoder, cfg,
                                 xs.to(torch.bfloat16))
    return float((e16.float() - e32).abs().max()), float(e32.abs().max())


def phase_slice(torch):
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    audio = synthetic_audio(0)
    emit({'phase': 'slice', 'config': 'flagfiles/E6D2.txt', 'params':
          n_params, 'input_size': cfg.input_size, 'audio_s': len(audio) /
          16000, 'weights': 'random, seed 0'})

    cuda32, tok32 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            count='decode_wav')
    cpu32, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu')
    cuda16, tok16 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            torch.bfloat16)
    equal = tok32.shape == tok_cpu.shape and bool((tok32 == tok_cpu).all())
    res = {'phase': 'slice', 'frames': int(tok32.size),
           'nonblank_frames': int((tok32 != 0).sum()),
           'chunks': len(cuda32.elapsed),
           'cuda_fp32_equals_cpu': equal,
           'chunk_ms_cuda_fp32': 1e3 * float(np.mean(cuda32.elapsed)),
           'chunk_ms_cuda_bf16': 1e3 * float(np.mean(cuda16.elapsed)),
           'chunk_ms_cpu_fp32': 1e3 * float(np.mean(cpu32.elapsed)),
           'bf16_token_agreement': _agreement(tok16, tok32)}
    res['bf16_encoder_max_abs'], res['encoder_out_max_abs'] = \
        _bf16_encoder_diff(torch, cfg, cuda32, cuda16, audio)
    if not equal:
        k, gap = _first_divergence(torch, model, cfg, feat, tok, audio,
                                   tok_cpu, tok32)
        res.update(first_diverging_frame=k, top2_gap=gap)
    emit(res)
    require(equal, 'cuda fp32 tokens differ from the CPU run')
    require(res['nonblank_frames'] > 0, 'no token emitted')
    STATE['model'] = model
    STATE['tokens_fp32'] = tok32
    STATE['chunk_ms'] = res['chunk_ms_cuda_fp32']


def phase_slice_int8(torch):
    """E6D2 StreamingDecoder(quantize='int8'), fp32, on the slice's model
    and audio: cuda tokens == the CPU plain int8 run's; int8-vs-fp32 token
    agreement; per-chunk ms; the encoder's bytes int8 against fp32."""
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.ops.quant import module_bytes
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = STATE['model']
    audio = synthetic_audio(0)
    cuda8, tok8 = _decode(model, cfg, feat, tok, audio, 'cuda',
                          quantize='int8', count='decode_wav_int8')
    cpu8, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu',
                            quantize='int8')
    equal = tok8.shape == tok_cpu.shape and bool((tok8 == tok_cpu).all())
    res = {'phase': 'slice_int8', 'quantize': 'int8', 'dtype': 'fp32',
           'frames': int(tok8.size), 'nonblank_frames': int((tok8 != 0).sum()),
           'chunks': len(cuda8.elapsed), 'cuda_int8_equals_cpu_int8': equal,
           'int8_vs_fp32_token_agreement': _agreement(tok8,
                                                      STATE['tokens_fp32']),
           'chunk_ms_cuda_int8': 1e3 * float(np.mean(cuda8.elapsed)),
           'chunk_ms_cpu_int8': 1e3 * float(np.mean(cpu8.elapsed)),
           'encoder_bytes_int8': module_bytes(cuda8.model.encoder),
           'encoder_bytes_fp32': module_bytes(model.encoder)}
    emit(res)
    require(equal, 'cuda int8 tokens differ from the CPU int8 run')
    require(res['nonblank_frames'] > 0, 'no token emitted')
    require(res['encoder_bytes_int8'] < 0.3 * res['encoder_bytes_fp32'],
            'the int8 encoder is not a quarter of the fp32 one')


def phase_slice_gru(torch):
    """E6D2 widths with enc_type GRU (seeded random weights): cuda fp32
    == CPU and cuda int8 == CPU int8, token for token; bf16 encoder diff and
    token agreement; per-chunk ms."""
    import dataclasses

    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    cfg = dataclasses.replace(cfg, module_type='GRU')
    tok = StandInTokenizer(cfg.vocab_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    audio = synthetic_audio(0)
    emit({'phase': 'slice_gru', 'config': 'flagfiles/E6D2.txt --enc_type GRU',
          'params': sum(p.numel() for p in model.parameters()),
          'weights': 'random, seed 0'})
    cuda32, tok32 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            count='decode_wav_gru')
    _, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu')
    cuda8, tok8 = _decode(model, cfg, feat, tok, audio, 'cuda',
                          quantize='int8', count='decode_wav_gru_int8')
    _, tok8_cpu = _decode(model, cfg, feat, tok, audio, 'cpu',
                          quantize='int8')
    cuda16, tok16 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            torch.bfloat16)
    eq32 = tok32.shape == tok_cpu.shape and bool((tok32 == tok_cpu).all())
    eq8 = tok8.shape == tok8_cpu.shape and bool((tok8 == tok8_cpu).all())
    res = {'phase': 'slice_gru', 'frames': int(tok32.size),
           'nonblank_frames': int((tok32 != 0).sum()),
           'chunks': len(cuda32.elapsed),
           'cuda_fp32_equals_cpu': eq32, 'cuda_int8_equals_cpu_int8': eq8,
           'chunk_ms_cuda_fp32': 1e3 * float(np.mean(cuda32.elapsed)),
           'chunk_ms_cuda_bf16': 1e3 * float(np.mean(cuda16.elapsed)),
           'chunk_ms_cuda_int8': 1e3 * float(np.mean(cuda8.elapsed)),
           'bf16_token_agreement': _agreement(tok16, tok32),
           'int8_vs_fp32_token_agreement': _agreement(tok8, tok32)}
    res['bf16_encoder_max_abs'], res['encoder_out_max_abs'] = \
        _bf16_encoder_diff(torch, cfg, cuda32, cuda16, audio)
    emit(res)
    require(eq32, 'GRU cuda fp32 tokens differ from the CPU run')
    require(eq8, 'GRU cuda int8 tokens differ from the CPU int8 run')
    require(res['nonblank_frames'] > 0, 'no token emitted')


def _serve(torch, dec, audios, run):
    """StreamServer over `dec`, built as cli/serve.py builds it (lockstep
    rounds); one concurrent client per audio, the launch counts of the
    clients' rounds alone to STATE['launches_' + run] → (transcripts,
    server)."""
    import asyncio

    from edgedict_tpu_torch.cli.serve import build_server
    from edgedict_tpu_torch.serving import stream_client
    server = build_server(dec, port=0, round_timeout_ms=0)   # lockstep
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    require(started.wait(120), 'server did not start')
    results = [None] * len(audios)

    def client(i):
        results[i] = stream_client('127.0.0.1', server.port, audios[i])

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(audios))]
        _reset_launches()
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        STATE['launches_' + run] = _launches()
        require(not any(c.is_alive() for c in clients), 'client timed out')
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
    return results, server


def phase_server(torch, quantize=None, n_streams=8):
    """StreamServer over MultiStreamDecoder(n_streams, cuda, quantize) as
    cli/serve.py builds it; 4 concurrent clients, each transcript ==
    decode_wav of its audio."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model = STATE.get('model') or T.Transducer(cfg, device='cpu', seed=0)
    audios = [synthetic_audio(10 + i, seconds=3.0) for i in range(4)]
    single = S.StreamingDecoder(model, cfg, feat, tok, device='cuda',
                                quantize=quantize)
    expected = [single.decode_wav(a) for a in audios]
    dec = S.MultiStreamDecoder(model, cfg, feat, tok, n_streams=n_streams,
                               device='cuda', quantize=quantize)
    run = 'server' if quantize is None else f'server_{quantize}'
    results, server = _serve(torch, dec, audios, run)
    match = [r == e for r, e in zip(results, expected)]
    res = {'phase': run, 'n_streams': dec.n, 'clients': len(audios),
           'rounds': server.rounds,
           'round_ms_mean': 1e3 * float(np.mean(dec.elapsed)),
           'transcripts_match': match,
           'transcript_chars': [len(r or '') for r in results]}
    emit(res)
    require(all(match), 'a server transcript differs from decode_wav')
    STATE['round_ms'] = res['round_ms_mean']


def phase_server_int8(torch):
    """The int8 server at 64 streams: x_proj's R = 2 x 64 rows (64 after
    the time reduction) put every K11 call on its tiled kernel."""
    phase_server(torch, quantize='int8', n_streams=64)


def _e6d2_train_cfg():
    """E6D2 TransducerConfig (V=2048) and the trainer's FeatureConfig from
    flagfiles/E6D2.txt, with dither and SpecAugment off."""
    import dataclasses

    from edgedict_tpu_torch import config as C
    parser = C.add_train_flags(C.add_model_flags(argparse.ArgumentParser()))
    flags = C.parse_flags(parser, [f'--flagfile={REPO}/flagfiles/E6D2.txt'])
    feat = dataclasses.replace(C.feature_config_from_flags(flags), dither=0.0,
                               T_num_mask=0, F_num_mask=0)
    return C.transducer_config_from_flags(flags, 2048, feat.input_size), feat


def phase_train_parity(torch, module_type='LSTM'):
    """One fp32 E6D2 train step (full width and depth, seeded init, B=4,
    ~2 s) on CUDA against the CPU plain path from the same weights and
    batch; dither and SpecAugment off so that both see the same features,
    lr 5e-4 (E6D2's, without warmup) so that the step moves the params.
    module_type='GRU': the same with the GRU encoder (K5/K6 on CUDA)."""
    import copy
    import dataclasses

    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2_train_cfg()
    cfg = dataclasses.replace(cfg, module_type=module_type)
    lr = 5e-4
    rng = np.random.RandomState(7)
    secs = (2.0, 1.8, 1.6, 2.0)
    audio = np.zeros((4, 32000), np.float32)
    for i, sec in enumerate(secs):
        audio[i, :int(sec * 16000)] = synthetic_audio(20 + i, sec)
    host = {'audio': audio,
            'alen': np.array([int(x * 16000) for x in secs], np.int32),
            'ys': rng.randint(4, 2048, (4, 12)).astype(np.int32),
            'ylen': np.array([12, 10, 8, 11], np.int32)}
    model = T.Transducer(cfg, device='cpu', seed=0)
    opt = optim.build_optimizer('adam')
    res = {}
    for dev in ('cuda', 'cpu'):
        m = copy.deepcopy(model).to(dev)
        pipe = FeaturePipeline(feat, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        batch = TR.device_batch(host, 1, dev)
        micro = {k: v[0] for k, v in batch.items()}
        xs, xlen = pipe(micro['audio'], micro['alen'], train=True,
                        generator=gen)
        loss = T.transducer_loss(m, cfg, xs, micro['ys'], xlen,
                                 micro['ylen'], deterministic=False,
                                 generator=gen)
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        state = TR.TrainState(m, opt.init(dict(m.named_parameters())))
        step = TR.make_train_step(cfg, opt, bf16=False, feature_pipeline=pipe)
        t0 = time.perf_counter()
        state, met = step(state, batch, lr, gen)
        res[dev] = {'loss': float(met['loss']),
                    'grad_norm': float(met['grad_norm']),
                    'skipped': float(met['skipped']),
                    'step_s': time.perf_counter() - t0, 'grads': grads,
                    'params': {k: v.detach().cpu() for k, v in
                               state.model.state_dict().items()}}
    a, b = res['cuda'], res['cpu']
    grad_rel = max(float((a['grads'][k] - g).abs().max())
                   / max(1e-30, float(g.abs().max()))
                   for k, g in b['grads'].items())
    diffs = [(a['params'][k] - p).abs() for k, p in b['params'].items()]
    moved = max(float((b['params'][k] - model.state_dict()[k]).abs().max())
                for k in b['params'])
    n = sum(d.numel() for d in diffs)
    out = {'phase': 'train_parity' + ('_gru' if module_type == 'GRU'
                                       else ''),
           'config': 'flagfiles/E6D2.txt fp32' + (
               ' --enc_type GRU' if module_type == 'GRU' else ''),
           'params': sum(p.numel() for p in model.parameters()), 'B': 4, 'audio_s': list(secs), 'lr': lr,
           'loss_cuda': a['loss'], 'loss_cpu': b['loss'],
           'loss_rel': abs(a['loss'] - b['loss']) / abs(b['loss']),
           'grad_norm_rel': abs(a['grad_norm'] - b['grad_norm'])
           / b['grad_norm'],
           'grad_max_rel': grad_rel,
           'param_max_abs_diff': max(float(d.max()) for d in diffs),
           'param_share_diff_over_0.01lr':
               sum(int((d > 0.01 * lr).sum()) for d in diffs) / n,
           'param_max_update': moved,
           'step_s_cuda': a['step_s'], 'step_s_cpu': b['step_s'],
           'bounds': 'loss 1e-5 rel, grad_norm 1e-4 rel, each grad 1e-3 of '
                     'its max, params max 2 lr and > 0.01 lr on < 1e-3 of '
                     'them (Adam\'s first step is g/|g|: a grad at its '
                     'rounding level may flip sign)'}
    emit(out)
    require(a['skipped'] == b['skipped'] == 0.0, 'a parity step was skipped')
    require(out['loss_rel'] <= 1e-5 and out['grad_norm_rel'] <= 1e-4
            and grad_rel <= 1e-3, 'CUDA train step differs from the CPU')
    require(out['param_max_abs_diff'] <= 2 * lr + 1e-6
            and out['param_share_diff_over_0.01lr'] <= 1e-3,
            'params after the step differ between CUDA and the CPU')


def _synthetic_corpus(root, texts, seed, lo=8.0, hi=16.0):
    """LibriSpeech layout (<root>/<spk>/<chap>/*.trans.txt + wav) of one
    utterance of lo..hi seconds of synthetic audio per text."""
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    from edgedict_tpu_torch.data.audio_io import save_wav
    rng = np.random.RandomState(seed)
    d = os.path.join(root, '1', '1')
    os.makedirs(d, exist_ok=True)
    lines = []
    for i, text in enumerate(texts):
        name = f'1-1-{i:04d}'
        save_wav(os.path.join(d, name + '.wav'),
                 synthetic_audio(seed + i, rng.uniform(lo, hi)), 16000)
        lines.append(f'{name} {text.upper()}')
    with open(os.path.join(d, '1-1.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _corpus_texts(n_train, n_eval, seed=0):
    """Texts over a seeded lexicon of 800 made-up words, each used twice in
    the training texts, so that BPE training reaches 2048 ids."""
    rng = np.random.RandomState(seed)
    letters = np.array(list('abcdefghijklmnopqrstuvwxyz'))
    lex = []
    while len(lex) < 800:
        w = ''.join(rng.choice(letters, rng.randint(4, 10)))
        if w not in lex:
            lex.append(w)
    stream = list(rng.permutation(lex + lex))
    train = [' '.join(c) for c in np.array_split(stream, n_train)]
    evals = [' '.join(rng.choice(lex, 12)) for _ in range(n_eval)]
    return train, evals


def _train_corpus():
    """The synthetic corpus of the train_run phases, written once into a
    temp dir that main() removes: → (dir, trainer argv without --name)."""
    import tempfile
    if 'train_corpus' not in STATE:
        tmp = tempfile.mkdtemp(prefix='edd_smoke_')
        STATE['train_corpus'] = (tmp, None)
        train_texts, eval_texts = _corpus_texts(96, 8)
        _synthetic_corpus(os.path.join(tmp, 'train'), train_texts, 100)
        _synthetic_corpus(os.path.join(tmp, 'test'), eval_texts, 900)
        none = os.path.join(tmp, 'none')
        argv = [f'--flagfile={REPO}/flagfiles/E6D2.txt',
                '--LibriSpeech_train_100', os.path.join(tmp, 'train'),
                '--LibriSpeech_train_360', none,
                '--LibriSpeech_train_500', none,
                '--LibriSpeech_test', os.path.join(tmp, 'test'),
                '--TEDLIUM_train', none, '--CommonVoice', none,
                '--YT_bloomberg2', none, '--YT_life', none,
                '--logdir_root', os.path.join(tmp, 'logs'),
                '--device', 'cuda']
        STATE['train_corpus'] = (tmp, argv)
    return STATE['train_corpus']


def phase_train_run(torch, enc_type='LSTM'):
    """The port's Trainer, built as cli/baseline.py builds it, from
    flagfiles/E6D2.txt (batch 32, bf16, BPE 2048) with --enc_type on a
    synthetic corpus of 8-16 s utterances (shared by both encoders, the
    BPE model trained once): warm-up steps, then measured steps; loss
    falls on a repeated small batch; one --mode eval pass.  GRU: also one
    step with --time_warp_w 80 --optim novograd."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.train import device_batch, make_train_state
    from edgedict_tpu_torch.trainer import Trainer
    gru = enc_type == 'GRU'
    run = 'train_gru' if gru else 'train'
    cwd = os.getcwd()
    t0 = time.perf_counter()
    tmp, base = _train_corpus()
    os.chdir(tmp)                 # the BPE-2048/ cache lands in the cwd
    try:
        argv = base + ['--name', f'e6d2-{enc_type.lower()}', '--enc_type',
                       enc_type]
        flags = parse_flags(baseline.build_parser(), argv)
        trainer = Trainer(flags)
        setup_s = time.perf_counter() - t0
        vocab = trainer.tokenizer.vocab_size
        require(vocab == 2048 and trainer.cfg.vocab_size == 2048,
                f'vocab is {vocab}, not 2048')
        require(trainer.cfg.module_type == enc_type,
                f'the trainer built a {trainer.cfg.module_type} encoder')

        def batches():
            while True:
                yield from trainer.loader

        it = batches()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):                                  # warm-up
            float(trainer.run_step(next(it))['loss'])
        _reset_launches()
        times, audio_s, losses, shapes = [], [], [], []
        n_measured = 5
        for _ in range(n_measured):
            batch = next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(trainer.run_step(batch)['loss']))
            times.append(time.perf_counter() - t1)
            audio_s.append(float(batch['alen'].sum()) / 16000.0)
            shapes.append([int(x) for x in batch['audio'].shape[1:]]
                          + [int(batch['ys'].shape[1]) + 1])
        STATE['launches_' + run] = _launches()
        it.close()
        med = statistics.median(times)
        n = trainer.accum_steps * n_measured        # micro-steps measured
        enc, dec = trainer.cfg.enc_layers, trainer.cfg.dec_layers
        STATE.setdefault('train_expect', {})[run] = {
            'lstm_fwd': (dec if gru else enc + dec) * n,
            'lstm_bwd': (dec if gru else enc + dec) * n,
            'gru_fwd': enc * n if gru else 0,
            'gru_bwd': enc * n if gru else 0,
            'mel_power': n, 'joint_lse_fwd': n, 'joint_lse_bwd': n,
            'lattice_alpha': n, 'lattice_beta_grad': n}
        res = {'phase': 'train_run' + ('_gru' if gru else ''),
               'config': 'flagfiles/E6D2.txt' + (' --enc_type GRU' if gru
                                                 else ''),
               'params': sum(p.numel() for p in
                             trainer.state.model.parameters()),
               'vocab': vocab, 'batch_size': flags.batch_size,
               'accum': trainer.accum_steps, 'bf16': flags.bf16,
               'utterances': len(trainer.train_dataset),
               'setup_s': setup_s,
               'batch_samples_U1': shapes,
               'step_ms': [1e3 * x for x in times],
               'step_ms_median': 1e3 * med,
               'audio_s_per_s': [a / x for a, x in zip(audio_s, times)],
               'audio_s_per_s_median': statistics.median(
                   a / x for a, x in zip(audio_s, times)),
               'losses': losses,
               'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}

        # loss falls on a repeated small batch (fresh weights, lr 1e-3)
        small = {k: v[:4] for k, v in next(iter(trainer.loader)).items()}
        dev_small = device_batch(small, 1, trainer.device)
        state = make_train_state(trainer.cfg, trainer.optimizer,
                                 trainer.device, seed=1)
        fall = []
        for _ in range(10):
            state, m = trainer.train_step(state, dev_small, 1e-3,
                                          trainer.generator)
            fall.append(float(m['loss']))
        res['repeated_batch_losses'] = fall
        del state

        trainer.save()
        lines = []
        # the LSTM run's eval pass also decodes with a W=4 beam
        beam = [] if gru else ['--eval_beam_width', str(BEAM['beam_width'])]
        require(flags.eval_batch_size == EVAL_BATCH,
                f'eval batch {flags.eval_batch_size}: phase_kernels holds K1 '
                f'at the beam eval\'s {EVAL_BATCH} x W rows')
        _reset_launches()
        evaluated = baseline.main(argv + ['--mode', 'eval'] + beam,
                                  log_fn=lines.append)
        torch.cuda.synchronize()
        STATE[f'launches_{run}_eval'] = _launches()
        STATE.setdefault('run_expect', {})[run + '_eval'] = _eval_expect(
            torch, evaluated, BEAM['beam_width'] if beam else 0)
        res.update(_eval_pass_times(torch, evaluated))
        del evaluated
        val = [ln for ln in lines if ln.startswith('val_loss')]
        res['eval'] = val[0] if val else None
        if gru:
            res['warp_novograd'] = _warp_novograd_step(torch, argv, batch)
        del trainer
        emit(res)
        require(all(np.isfinite(losses)), 'a train loss is not finite')
        require(fall[-1] < fall[0], f'loss did not fall: {fall}')
        require(bool(val) and np.isfinite(float(val[0].split()[1])),
                f'eval printed no finite val_loss: {lines}')
        if beam:
            words = val[0].split()
            require(words[4:5] == ['beam_WER']
                    and np.isfinite(float(words[5])),
                    f'eval printed no finite beam_WER: {val[0]}')
        if gru:
            w = res['warp_novograd']
            require(np.isfinite(w['loss']) and w['skipped'] == 0.0,
                    f'the time-warp + novograd step failed: {w}')
    finally:
        os.chdir(cwd)


def _eval_pass_times(torch, trainer):
    """A Trainer's greedy eval pass timed again after its counted run, on
    its eval batches already on the card: the wall ms of each batch's eval
    step (features, the fp32 loss through K7 and K9, the greedy decode;
    not the beam, whose host-bound search slice_beam times), and each
    kernel's device ms a batch by torch.profiler (EVAL_PARTS)."""
    model = trainer.eval_model()
    batches = [{k: torch.as_tensor(x).to(trainer.device)
                for k, x in batch.items()} for batch in trainer.eval_loader]

    def greedy_pass():
        for dev in batches:
            trainer.eval_step(model, dev)
    greedy_pass()
    steps = []
    for dev in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.eval_step(model, dev)
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t0))
    return {'eval_step_ms': steps, 'eval_batch_shapes': [
                list(dev['xs' if 'xs' in dev else 'audio'].shape)
                for dev in batches],
            'eval_kernel_device_ms_per_batch': {
                k: v / len(batches) for k, v in kernel_split_ms(
                    torch, greedy_pass, EVAL_PARTS, n=1).items()}}


def _warp_novograd_step(torch, argv, batch):
    """One measured step of a Trainer built with --time_warp_w 80 --optim
    novograd (the two training flags the slice added), on `batch`."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import Trainer
    flags = parse_flags(baseline.build_parser(), argv + [
        '--name', 'e6d2-gru-warp', '--time_warp_w', '80', '--optim',
        'novograd'])
    trainer = Trainer(flags)
    require(trainer.feature_cfg.W_warp == 80
            and trainer.optimizer.name == 'novograd',
            'the time-warp / novograd flags did not reach the trainer')
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = trainer.run_step(batch)
    loss = float(m['loss'])
    return {'flags': '--time_warp_w 80 --optim novograd', 'loss': loss,
            'skipped': float(m['skipped']),
            'step_ms': 1e3 * (time.perf_counter() - t1)}


# the beam of the slice: E6D2, W=4, 3 label expansions a frame, prefix
# merging, 200 tokens; shallow fusion at cli/stream.py's default weight
BEAM = dict(beam_width=4, max_sym_per_frame=3, max_tokens=200)
LM_WEIGHT = 0.2
BEAM_SECONDS = 2.0         # slice_beam's seeded audio, seconds
# the beam paths' K1 / K4 shapes that phase_kernels and train_kernels hold
# against plain: server_beam's streams, train_run's eval batch (its beam
# eval runs W=4 too), lm_train's (H, B, T) at E6D2's batch
SERVER_BEAM_STREAMS = 8
EVAL_BATCH = 4
LM_TRAIN = (512, 32, 64)


def _beam_models(torch):
    """(model, lm triple) of the beam phases: the slice's seeded E6D2 model
    and a seeded LM at LMConfig's defaults (V=2048, 256 / 512 / 2 layers).
    Seeded random weights give near-uniform posteriors over 2048 labels,
    under which the all-blank path wins every beam (every frame pays one
    blank, each label costs ~7 nats more): the joint's output layer x32,
    its prediction-net columns x6 and the label embedding x4 make the
    posteriors peaky and the prediction net move them, as training does;
    the LM's output layer x4 makes it peaky too."""
    import copy

    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.models.lm import LMConfig, LMModel
    if 'beam_model' not in STATE:
        cfg, _ = _e6d2()
        model = copy.deepcopy(STATE.get('model')
                              or T.Transducer(cfg, device='cpu', seed=0))
        lm = LMModel(LMConfig(vocab_size=cfg.vocab_size), 'cpu', seed=0)
        with torch.no_grad():
            model.joint.out.weight *= 32.0
            model.joint.joint[0].weight[:, cfg.enc_proj_size:] *= 6.0
            model.decoder.embed.weight *= 4.0
            lm.out.weight *= 4.0
        STATE['beam_model'] = model
        STATE['beam_lm'] = (lm, lm.cfg, LM_WEIGHT)
    return STATE['beam_model'], STATE['beam_lm']


def _beam_decode(torch, model, cfg, feat, tok, audio, device, dtype=None,
                 quantize=None, lm=None, count=None, warm=True):
    """StreamingBeamDecoder.decode_wav (after a warm-up one when `warm`,
    which also takes the smallest prune gap: STATE['prune_gap']) →
    (decoder, best tokens, best logp); with `count`, the launch counts of
    the measured decode alone go to STATE['launches_' + count]."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.models.beam_search import best_hypothesis
    dec = S.StreamingBeamDecoder(model, cfg, feat, tok, device=device,
                                 compute_dtype=dtype, quantize=quantize,
                                 lm=lm, **BEAM)
    if warm:
        STATE['prune_gap'] = _prune_gap(torch, dec, audio)
        dec.elapsed = []
    if count:
        _reset_launches()
    dec.decode_wav(audio)
    if count:
        STATE['launches_' + count] = _launches()
        STATE['chunks_' + count] = len(dec.elapsed)
        # encoder frames: each chunk's feature frames over the time scale
        per_chunk = -(-dec.rt.pipeline.num_frames(dec.win_size)
                      // cfg.time_scale)
        STATE['frames_' + count] = per_chunk * len(dec.elapsed)
    toks, n_tok, logp = best_hypothesis(dec.beam)
    return dec, toks[0, :int(n_tok[0])].cpu().numpy(), float(logp[0])


def _prune_gap(torch, dec, audio):
    """The smallest gap between the W-th and the (W+1)-th candidate, both
    live, at any prune of one decode_wav (top_k wrapped for this decode
    alone, its k best the same; its minima fetched once at the end)."""
    from edgedict_tpu_torch.models import beam_search as B
    plain, gaps = B.top_k, []

    def top_k(x, k):
        vals, idx = plain(x, k + 1)
        live = vals[..., k] > B.NEG / 2
        gaps.append(torch.where(live, vals[..., k - 1] - vals[..., k],
                                float('inf')).min())
        return vals[..., :k], idx[..., :k]

    B.top_k = top_k
    try:
        dec.decode_wav(audio)
    finally:
        B.top_k = plain
    return float(torch.stack(gaps).min())


def _device_profile(torch, run, n, unit):
    """One call of run() (n chunks or rounds) under torch.profiler: device
    ms, kernel and copy records and K1's device ms per `unit`, the busy
    share of the call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = records = k1 = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += e.device_time_total
            records += e.count
            if 'recur_fwd_kernel' in e.key:
                k1 += e.device_time_total
    return {f'profiled_wall_ms_per_{unit}': 1e3 * wall / n,
            f'device_ms_per_{unit}': us / 1e3 / n,
            'device_busy_share': us / 1e6 / wall,
            f'device_records_per_{unit}': records / n,
            f'k1_device_ms_per_{unit}': k1 / 1e3 / n}


def _token_agreement(a, b):
    """Positions where two token sequences agree, over the longer one."""
    n = max(len(a), len(b))
    m = min(len(a), len(b))
    return float((a[:m] == b[:m]).sum()) / n if n else 1.0


def phase_slice_beam(torch):
    """E6D2 StreamingBeamDecoder.decode_wav (W=4, fp32) of BEAM_SECONDS of
    seeded audio without LM, with LM and with quantize='int8': the cuda
    best hypothesis
    == the CPU run's, its logp within rel 1e-4, non-empty; bf16 agreement,
    the smallest prune gap, per-chunk wall ms and the profiled device ms;
    then cli.stream --beam_width 4 --lm_path <lm_train's lm.ckpt> on the
    same audio == decode_wav with that LM."""
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model, lm = _beam_models(torch)
    audio = synthetic_audio(0, seconds=BEAM_SECONDS)
    emit({'phase': 'slice_beam', 'config': 'flagfiles/E6D2.txt', **BEAM,
          'seconds': BEAM_SECONDS,
          'merge_prefixes': True, 'lm': 'LMConfig defaults (V=2048, 256 / '
          f'512 / 2), random seed 0, weight {LM_WEIGHT}',
          'weights': 'random, seed 0, joint output x32, prediction-net '
          'columns x6, label embedding x4, LM output x4'})
    for run, run_lm, quantize in (('beam', None, None),
                                  ('beam_lm', lm, None),
                                  ('beam_int8', None, 'int8')):
        cuda, t_cuda, lp_cuda = _beam_decode(
            torch, model, cfg, feat, tok, audio, 'cuda', quantize=quantize,
            lm=run_lm, count=run)
        cpu, t_cpu, lp_cpu = _beam_decode(
            torch, model, cfg, feat, tok, audio, 'cpu', quantize=quantize,
            lm=run_lm, warm=False)
        _, t16, lp16 = _beam_decode(torch, model, cfg, feat, tok, audio,
                                    'cuda', torch.bfloat16,
                                    quantize=quantize, lm=run_lm,
                                    warm=False)
        equal = t_cuda.shape == t_cpu.shape and bool((t_cuda == t_cpu).all())
        rel = abs(lp_cuda - lp_cpu) / max(1.0, abs(lp_cpu))
        res = {'phase': 'slice_beam', 'run': run, 'quantize': quantize,
               'lm': run_lm is not None, 'chunks': len(cuda.elapsed),
               'frames': STATE['frames_' + run], 'tokens': len(t_cuda),
               'cuda_equals_cpu': equal, 'logp_cuda': lp_cuda,
               'logp_cpu': lp_cpu, 'logp_rel': rel,
               'tol': 'tokens exact, logp rel 1e-4',
               'bf16_tokens_equal': t16.shape == t_cuda.shape
               and bool((t16 == t_cuda).all()),
               'bf16_token_agreement': _token_agreement(t16, t_cuda),
               'logp_bf16': lp16,
               'chunk_ms_cuda': 1e3 * float(np.mean(cuda.elapsed)),
               'chunk_ms_cpu': 1e3 * float(np.mean(cpu.elapsed)),
               'min_prune_gap': STATE['prune_gap']}
        res.update(_device_profile(torch, lambda: cuda.decode_wav(audio),
                                   res['chunks'], 'chunk'))
        res['k1_launches_per_chunk'] = \
            STATE['launches_' + run]['lstm_fwd'] / res['chunks']
        emit(res)
        require(equal, f'{run}: cuda tokens differ from the CPU run')
        require(rel <= 1e-4, f'{run}: best logp {lp_cuda} vs CPU {lp_cpu}')
        require(len(t_cuda) > 0, f'{run}: empty best hypothesis')
    res = _cli_beam_run(torch, model, cfg, feat, audio)
    emit(res)
    require(res['lm_fusion_line'] and res['transcript_equals_decode_wav'],
            f'cli.stream --beam_width 4 --lm_path disagrees: {res}')


def _cli_beam_run(torch, model, cfg, feat, audio):
    """cli.stream --beam_width 4 --lm_path <lm_train's lm.ckpt> --pt_path
    <the beam model> on a wav of `audio` (fp32, the corpus's BPE 2048
    tokenizer), against StreamingBeamDecoder.decode_wav with that LM."""
    import contextlib
    import io

    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli import stream as CS
    from edgedict_tpu_torch.data.audio_io import load_audio, save_wav
    from edgedict_tpu_torch.models.lm import load_lm_checkpoint
    tmp, _ = _train_corpus()
    pt = os.path.join(tmp, 'beam_model.pt')
    torch.save({'model': model.state_dict()}, pt)
    wav = os.path.join(tmp, 'beam.wav')
    save_wav(wav, audio, 16000)
    lm_path = STATE['lm_path']
    cwd = os.getcwd()
    os.chdir(tmp)                 # the BPE-2048/ cache of the corpus
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            CS.main([f'--flagfile={REPO}/flagfiles/E6D2.txt',
                     '--logdir_root', os.path.join(tmp, 'logs'),
                     '--pt_path', pt, '--path', wav, '--device', 'cuda',
                     '--infer_dtype', 'fp32', '--beam_width', '4',
                     '--lm_path', lm_path])
        lines = out.getvalue().splitlines()
        tok = CS.build_tokenizer(argparse.Namespace(tokenizer='bpe',
                                                    bpe_size=2048))
        lm_model, lm_cfg = load_lm_checkpoint(lm_path)
        samples, _ = load_audio(wav)
        expect = S.StreamingBeamDecoder(
            model, cfg, feat, tok, device='cuda',
            lm=(lm_model, lm_cfg, LM_WEIGHT), **BEAM).decode_wav(samples)
    finally:
        os.chdir(cwd)
    return {'phase': 'slice_beam', 'run': 'cli.stream --beam_width 4 '
            '--lm_path', 'lm_path': os.path.relpath(lm_path, tmp),
            'lines': lines[:2] + lines[3:],
            'lm_fusion_line': len(lines) > 2 and lines[1]
            == f'LM fusion: {lm_path} (lambda={LM_WEIGHT})',
            'transcript_chars': len(expect),
            'transcript_equals_decode_wav': len(lines) > 2
            and lines[2] == expect}


def phase_server_beam(torch):
    """StreamServer over MultiStreamBeamDecoder(n_streams=8, W=4, the LM)
    as cli/serve.py --beam_width 4 --lm_path builds it ('=' replace
    messages); 4 clients, each final transcript == decode_wav."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model, lm = _beam_models(torch)
    audios = [synthetic_audio(10 + i, seconds=3.0) for i in range(4)]
    single = S.StreamingBeamDecoder(model, cfg, feat, tok, device='cuda',
                                    lm=lm, **BEAM)
    expected = [single.decode_wav(a) for a in audios]
    dec = S.MultiStreamBeamDecoder(model, cfg, feat, tok,
                                   n_streams=SERVER_BEAM_STREAMS,
                                   device='cuda', lm=lm, **BEAM)
    results, server = _serve(torch, dec, audios, 'server_beam')
    match = [r == e for r, e in zip(results, expected)]
    res = {'phase': 'server_beam', 'n_streams': dec.n, 'clients':
           len(audios), 'beam_width': BEAM['beam_width'], 'lm': True,
           'full_hypothesis': server.full_hypothesis,
           'rounds': server.rounds,
           'round_ms_mean': 1e3 * float(np.mean(dec.elapsed)),
           'transcripts_match': match,
           'transcript_chars': [len(r or '') for r in results]}
    # the same rounds driven directly (4 streams of audio, 4 of silence),
    # under the profiler
    chunks = [S._chunks(a, dec.win_size, dec.hop_size) for a in audios]
    frames = np.zeros((len(chunks[0]), dec.n, dec.win_size), np.float32)
    for i, c in enumerate(chunks):
        frames[:, i] = c

    def rounds():
        dec.reset()
        for f in frames:
            dec.decode(f)

    res.update(_device_profile(torch, rounds, len(frames), 'round'))
    emit(res)
    require(server.full_hypothesis, 'the beam server sends no = messages')
    require(all(match), 'a beam server transcript differs from decode_wav')
    require(any(results), 'every beam server transcript is empty')


def phase_lm_train(torch):
    """cli.train_lm at LMConfig's defaults (256 / 512 / 2, V=2048) on the
    train_run corpus's texts with its BPE 2048, at E6D2's batch 32 and
    lm_seq_len 64 (LM_TRAIN, the K1 / K4 shape held against plain), lr
    1e-3, for about 20 steps: the loss is finite and falls, lm.ckpt is
    written (slice_beam's CLI run loads it); K1 and K4 per LSTM layer and
    step."""
    import dataclasses

    from edgedict_tpu_torch.cli import train_lm
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import build_datasets, build_tokenizer
    tmp, base = _train_corpus()
    cwd = os.getcwd()
    os.chdir(tmp)                 # the BPE-2048/ cache of the corpus
    try:
        argv = base + ['--name', 'lm', '--lr', '1e-3', '--loss_step', '1',
                       '--save_step', '5']
        flags = parse_flags(train_lm.build_parser(), argv)
        require((flags.lm_hidden_size, flags.batch_size, flags.lm_seq_len)
                == LM_TRAIN, f'cli.train_lm does not run at {LM_TRAIN}')
        tok = build_tokenizer(flags)
        texts = [t for d in build_datasets(flags, tok)[0] for t in d.texts()]
        per_epoch = sum(1 for _ in train_lm.batch_texts(
            texts, tok, flags.lm_seq_len, flags.batch_size,
            np.random.RandomState(0)))
        require(per_epoch > 0, 'the corpus gives no LM batch')
        epochs = -(-20 // per_epoch)
        lines = []
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm, cfg = train_lm.main(argv + ['--epochs', str(epochs)],
                                log_fn=lines.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        STATE['launches_lm_train'] = _launches()
        losses = [float(ln.split()[5]) for ln in lines]
        STATE['lm_train_expect'] = {'lstm_fwd': cfg.num_layers * len(losses),
                                    'lstm_bwd': cfg.num_layers * len(losses)}
        STATE['lm_path'] = os.path.join(tmp, 'logs', 'lm', 'lm.ckpt')
        res = {'phase': 'lm_train', 'lm_cfg': dataclasses.asdict(cfg),
               'params': sum(p.numel() for p in lm.parameters()),
               'batch_size': flags.batch_size, 'seq_len': flags.lm_seq_len,
               'epochs': epochs, 'steps': len(losses), 'losses': losses,
               'wall_s': wall, 'ms_per_step': 1e3 * wall / len(losses),
               'lm_ckpt': os.path.isfile(STATE['lm_path'])}
        emit(res)
        require((cfg.vocab_size, cfg.embed_size, cfg.hidden_size,
                 cfg.num_layers) == (2048, 256, 512, 2),
                f'the LM is not at the defaults: {cfg}')
        require(all(np.isfinite(losses)), 'an LM loss is not finite')
        require(losses[-1] < losses[0], f'LM loss did not fall: {losses}')
        require(res['lm_ckpt'], 'cli.train_lm wrote no lm.ckpt')
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# wav2vec 2.0 pretraining and the raw-waveform fine-tune
# ---------------------------------------------------------------------------

W2V_NAME = 'w2v'         # one run name: cli.train --use_pretrained reads
                         # logs/<name>/pretrained.ckpt


def _expect(**counts):
    """Launch counts of a run: the named kernels, every other one 0."""
    return {k: counts.get(k, 0) for k in SOURCES}


# the kernels of an eval pass, for its device ms by torch.profiler
EVAL_PARTS = {'K1': ('recur_fwd_kernel',), 'K3': ('greedy_frame_kernel',),
              'K7': ('joint_lse_fwd',), 'K9': ('lattice_alpha_kernel',)}


def _raw_lattices(batches, accum, spec):
    """{(B, T, U+1): (xlen, ylen) of its first micro-batch} of the raw
    fine-tune's host batches, each split into accum micro-batches as
    train.device_batch splits it: T the FrontEnd frames of the padded
    audio, xlen raw_trainer.frame_lengths'."""
    import torch

    from edgedict_tpu_torch.models.wav2vec import frontend_output_length
    from edgedict_tpu_torch.raw_trainer import frame_lengths
    out = {}
    for batch in batches:
        n = batch['audio'].shape[1]
        t = frontend_output_length(spec, n)
        xlen = frame_lengths(torch.as_tensor(batch['alen']), n, t).numpy()
        ylen = np.asarray(batch['ylen'])
        b = batch['audio'].shape[0] // accum
        for i in range(accum):
            out.setdefault((b, t, batch['ys'].shape[1] + 1),
                           (xlen[i * b:(i + 1) * b], ylen[i * b:(i + 1) * b]))
    return out


def _eval_expect(torch, trainer, beam_width):
    """What a feature Trainer's evaluate() launches: per eval batch K2
    once, the encoder's K1 (K5 for GRU) twice per layer (the loss, the
    greedy decode), the prediction net's K1 twice per layer (the loss, the
    decode's priming step), K7, K9 and K3 once; a beam of width W adds per
    batch K2 and the encoder once more, the initial beam's prediction net,
    and at B·W rows, T = 1, the prediction net for each of
    max_sym_per_frame expansions of every encoder frame.  Runs the
    pipeline (K2) for the frame counts: call it after reading the
    counts."""
    cfg = trainer.cfg
    batches = list(trainer.eval_loader)
    n = len(batches)
    enc = 'gru_fwd' if cfg.module_type == 'GRU' else 'lstm_fwd'
    counts = {'mel_power': n, 'greedy_decode': n, 'joint_lse_fwd': n,
              'lattice_alpha': n, 'lstm_fwd': 2 * n * cfg.dec_layers}
    counts[enc] = counts.get(enc, 0) + 2 * n * cfg.enc_layers
    if beam_width:
        frames = sum(-(-trainer.pipeline(
            torch.as_tensor(x['audio']).to(trainer.device),
            torch.as_tensor(x['alen']).to(trainer.device))[0].shape[1]
            // cfg.time_scale) for x in batches)
        counts['mel_power'] += n
        counts['lstm_fwd'] += (n * (cfg.enc_layers + cfg.dec_layers)
                               + frames * BEAM['max_sym_per_frame']
                               * cfg.dec_layers)
    return _expect(**counts)


def phase_pretrain_parity(torch):
    """One fp32 step of the full-width wav2vec model (E6D2's encoder, 6 x
    1024 LSTM, projection 640, input 128; final_dim 256, 2 x 320 codebook,
    100 negatives: pretrain_config.py's defaults) through
    Wav2VecPretrainer.run_step on CUDA and on the CPU plain path: two
    pretrainers from the same flags (batch 8; their seeded init, crops of
    longer utterances to 48,000 samples and masks by make_batch), the same
    injected draws (Gumbel noise, negative indices), at host step 1 of a
    one-step warmup (lr and Gumbel temperature from the pretrainer's own
    schedules); loss, grad_norm, the grads of the pretrainer's loss_fn and
    the params after its AdamW without decay of 1-D params."""
    from edgedict_tpu_torch.cli import pretrain_wav2vec as CP
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.models import wav2vec as W
    from edgedict_tpu_torch.pretrainer import Wav2VecPretrainer
    from edgedict_tpu_torch.train import device_batch
    tmp, _ = _train_corpus()
    b, step = 8, 1
    samples = [(synthetic_audio(30 + i, 3.5), None) for i in range(b)]
    pres, res = {}, {}
    for dev in ('cpu', 'cuda'):
        flags = parse_flags(CP.build_parser(), [
            f'--flagfile={REPO}/flagfiles/E6D2.txt', '--batch_size', str(b),
            '--sub_batch_size', str(b), '--warmup_step', '1',
            '--logdir_root', os.path.join(tmp, 'logs'), '--name',
            'w2v-parity', '--device', dev])
        pres[dev] = pre = Wav2VecPretrainer(flags, samples)
        pre.host_step = step
    cfg, pre = pres['cpu'].cfg, pres['cpu']
    require((cfg.enc_layers, cfg.enc_hidden_size, cfg.enc_proj_size,
             cfg.input_size, cfg.final_dim, cfg.latent_vars,
             cfg.latent_groups, cfg.num_negatives) ==
            (6, 1024, 640, 128, 256, 320, 2, 100),
            f'the pretraining config is not at full width: {cfg}')
    hosts = {dev: p.make_batch(samples) for dev, p in pres.items()}
    require(all(np.array_equal(hosts['cpu'][k], hosts['cuda'][k])
                for k in hosts['cpu']),
            'the two pretrainers cropped or masked differently')
    host = hosts['cpu']
    n = host['audio'].shape[1]
    t = W.frontend_output_length(cfg.frontend_params, n)
    m = host['mask_idx'].shape[1]
    draws = W.make_draws(cfg, b, t, m, torch.Generator().manual_seed(5),
                         'cpu')
    pres['cuda'].state.model.load_state_dict(pre.state.model.state_dict())
    init = {k: v.clone() for k, v in pre.state.model.state_dict().items()}
    lr, temp = pre.learning_rate(step), pre.temperature(step)
    for dev in ('cuda', 'cpu'):
        p = pres[dev]
        dd = {k: v.to(dev) for k, v in draws.items()}
        micro = {k: v[0] for k, v in device_batch(host, 1, dev).items()}
        loss, _ = p.loss_fn(p.state.model, micro, None,
                            {'temp': temp, 'draws': dd})
        loss.backward()
        grads = {k: q.grad.detach().cpu()
                 for k, q in p.state.model.named_parameters()}
        for q in p.state.model.parameters():
            q.grad = None
        t0 = time.perf_counter()
        met = p.run_step(host, draws=dd)
        res[dev] = {'loss': float(met['loss']),
                    'grad_norm': float(met['grad_norm']),
                    'skipped': float(met['skipped']),
                    'correct': float(met['correct']),
                    'step_s': time.perf_counter() - t0, 'grads': grads,
                    'params': {k: v.detach().cpu() for k, v in
                               p.state.model.state_dict().items()}}
    a, c = res['cuda'], res['cpu']
    grad_rel = max(float((a['grads'][k] - g).abs().max())
                   / max(1e-30, float(g.abs().max()))
                   for k, g in c['grads'].items())
    diffs = [(a['params'][k] - q).abs() for k, q in c['params'].items()]
    moved = max(float((c['params'][k] - init[k]).abs().max())
                for k in c['params'])
    n_params = sum(d.numel() for d in diffs)
    out = {'phase': 'pretrain_parity',
           'config': 'flagfiles/E6D2.txt encoder, pretrain_config defaults, '
                     'fp32', 'params': sum(q.numel() for q in
                                           pre.state.model.parameters()),
           'B': b, 'samples': n, 'T': t, 'masked': m, 'host_step': step,
           'lr': lr, 'temp': temp, 'bf16_flag': pre.flags.bf16,
           'loss_cuda': a['loss'], 'loss_cpu': c['loss'],
           'loss_rel': abs(a['loss'] - c['loss']) / abs(c['loss']),
           'grad_norm_rel': abs(a['grad_norm'] - c['grad_norm'])
           / c['grad_norm'], 'grad_max_rel': grad_rel,
           'correct_cuda': a['correct'], 'correct_cpu': c['correct'],
           'param_max_abs_diff': max(float(d.max()) for d in diffs),
           'param_share_diff_over_0.01lr':
               sum(int((d > 0.01 * lr).sum()) for d in diffs) / n_params,
           'param_max_update': moved,
           'step_s_cuda': a['step_s'], 'step_s_cpu': c['step_s'],
           'bounds': 'loss 1e-5 rel, grad_norm 1e-4 rel, each grad 1e-3 of '
                     'its max, params max 2 lr and > 0.01 lr on < 1e-3 of '
                     'them (as train_parity)'}
    emit(out)
    require(a['skipped'] == c['skipped'] == 0.0, 'a parity step was skipped')
    require(out['loss_rel'] <= 1e-5 and out['grad_norm_rel'] <= 1e-4
            and grad_rel <= 1e-3, 'CUDA pretraining step differs from the CPU')
    require(out['param_max_abs_diff'] <= 2 * lr + 1e-6 and moved > 0
            and out['param_share_diff_over_0.01lr'] <= 1e-3,
            'params after the pretraining step differ between CUDA and CPU')


def phase_pretrain_run(torch):
    """The wav2vec pretrainer, built as cli.pretrain_wav2vec builds it,
    from flagfiles/E6D2.txt (batch 32 of 48,000-sample crops, fp32) on the
    train_run corpus: a warm-up step, then measured steps (step ms,
    audio-s/s, peak memory, busy share of one more step); then
    cli.pretrain_wav2vec itself for one epoch (3 steps, one eval of the
    held-out set): finite losses, accuracies in [0, 1], pretrained.ckpt
    written.  K1 and K4: one per encoder layer and micro-step, K1 also per
    layer and eval batch."""
    from edgedict_tpu_torch.cli import pretrain_wav2vec as CP
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.data import DataLoader, MergedDataset
    from edgedict_tpu_torch.models import wav2vec as W
    from edgedict_tpu_torch.pretrainer import Wav2VecPretrainer
    from edgedict_tpu_torch.trainer import build_datasets
    tmp, base = _train_corpus()
    argv = base + ['--name', W2V_NAME, '--loss_step', '1',
                   '--eval_iteration', '3', '--epochs', '1']
    t0 = time.perf_counter()
    flags = parse_flags(CP.build_parser(), argv)
    train_sets, eval_set = build_datasets(flags, CP.NullTokenizer())
    pre = Wav2VecPretrainer(flags, MergedDataset(train_sets), eval_set)
    loader = DataLoader(pre.train_dataset, flags.batch_size, prefetch=0,
                        collate_fn=pre.make_batch, workers=flags.num_workers)
    batches = list(loader)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    float(pre.run_step(batches[0])['loss'])                  # warm-up
    _reset_launches()
    times, metrics = [], []
    for batch in batches * 2:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = pre.run_step(batch)
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(time.perf_counter() - t1)
    STATE['launches_pretrain'] = _launches()
    n = pre.accum_steps * len(times)
    enc = pre.cfg.enc_layers
    frames = W.frontend_output_length(pre.cfg.frontend_params,
                                      flags.pretrain_audio_samples)
    shapes = STATE.setdefault('w2v_shapes', {})
    shapes['pretrain'] = sorted({
        (x['audio'].shape[0] // pre.accum_steps,
         W.frontend_output_length(pre.cfg.frontend_params,
                                  x['audio'].shape[1])) for x in batches})
    expect = STATE.setdefault('run_expect', {})
    expect['pretrain'] = _expect(lstm_fwd=enc * n, lstm_bwd=enc * n)
    audio_s = pre.flags.batch_size * flags.pretrain_audio_samples / 16000
    med = statistics.median(times)
    res = {'phase': 'pretrain_run',
           'config': 'flagfiles/E6D2.txt, pretrain_config defaults',
           'params': sum(p.numel() for p in pre.state.model.parameters()),
           'batch_size': flags.batch_size, 'accum': pre.accum_steps,
           'samples': flags.pretrain_audio_samples, 'setup_s': setup_s,
           'utterances': len(pre.train_dataset),
           'step_ms': [1e3 * x for x in times], 'step_ms_median': 1e3 * med,
           'audio_s_per_s_median': audio_s / med,
           'losses': [x['loss'] for x in metrics],
           'accuracy': [x['correct'] / x['count'] for x in metrics],
           'prob_perplexity': [x['prob_perplexity'] for x in metrics],
           'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
    res.update(_device_profile(torch, lambda: float(
        pre.run_step(batches[0])['loss']), 1, 'step'))
    del pre, loader, batches
    lines = []
    _reset_launches()
    cli = CP.main(argv, log_fn=lines.append)
    STATE['launches_pretrain_cli'] = _launches()
    evals = [ln for ln in lines if ln.startswith('eval @')]
    bs = flags.eval_batch_size
    n_eval = len(evals) * (min(len(cli.eval_dataset), 8 * bs) // bs)
    expect['pretrain_cli'] = _expect(
        lstm_fwd=enc * (cli.accum_steps * cli.host_step + n_eval),
        lstm_bwd=enc * cli.accum_steps * cli.host_step)
    # the CLI's steps crop as the measured ones; its eval batches crop to
    # the same samples at the eval batch
    shapes['pretrain'] = sorted(set(shapes['pretrain']) | {
        (flags.batch_size // cli.accum_steps, frames)})
    shapes['pretrain_eval'] = [(bs, frames)] if n_eval else []
    STATE['pretrained'] = os.path.join(cli.logdir, 'pretrained.ckpt')
    res.update(cli_steps=cli.host_step, cli_log=lines,
               pretrained_ckpt=os.path.isfile(STATE['pretrained']))
    emit(res)
    losses = res['losses'] + [float(ln.split()[5]) for ln in lines
                              if ln.startswith('epoch')]
    accs = res['accuracy'] + [float(ln.split()[7]) for ln in lines
                              if ln.startswith('epoch')] \
        + [float(ln.split()[4]) for ln in evals]
    require(all(np.isfinite(losses)), 'a pretraining loss is not finite')
    require(all(0.0 <= a <= 1.0 for a in accs), f'an accuracy is off: {accs}')
    require(evals and res['pretrained_ckpt'],
            'cli.pretrain_wav2vec ran no eval or wrote no pretrained.ckpt')


def phase_raw_train_run(torch):
    """The raw-waveform fine-tune as cli.train --use_pretrained builds it
    (RawTrainer from flagfiles/E6D2.txt, batch 32, bf16, BPE 2048, the
    FrontEnd and encoder spliced from pretrain_run's pretrained.ckpt) on
    the train_run corpus (8-16 s, T up to 1601 FrontEnd frames, no time
    reduction): the spliced keys equal the checkpoint's bit for bit;
    warm-up, then measured steps (step ms, audio-s/s, peak memory, busy
    share of one more step); loss falling on a repeated small batch from
    a fresh init; cli.train --mode eval reloads the run (the saved
    weights, bit for bit) and prints a finite val_loss and WER.  Launches:
    per micro-step K1 and K4 one per LSTM layer (6 + 2), K7-K10 one each;
    per eval batch K1 twice per layer (the loss's encoder and prediction
    net, the decode's again), K3, K7 and K9 one each.  The shapes of the
    measured micro-batches and of the eval batches go to
    phase_wav2vec_kernels; the eval is also timed whole (wall and device
    ms a batch, each kernel's device ms)."""
    from edgedict_tpu_torch.checkpoint import (
        checkpoint_path, load_checkpoint)
    from edgedict_tpu_torch.cli import train as CT
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.models.wav2vec import (
        RawTransducer, frontend_output_length)
    from edgedict_tpu_torch.raw_trainer import RawTrainer
    from edgedict_tpu_torch.train import TrainState, device_batch
    cwd = os.getcwd()
    tmp, base = _train_corpus()
    os.chdir(tmp)                 # the BPE-2048/ cache of the corpus
    try:
        argv = base + ['--name', W2V_NAME, '--use_pretrained']
        t0 = time.perf_counter()
        flags = parse_flags(CT.build_parser(), argv)
        trainer = RawTrainer(flags)
        copied = trainer.load_pretrained(STATE['pretrained'])   # as cli.train
        setup_s = time.perf_counter() - t0
        src = load_checkpoint(STATE['pretrained'])['model']
        sd = trainer.state.model.state_dict()
        want = [k for k in src if k.split('.')[0] in ('frontend', 'encoder')]
        spliced = sorted(copied) == sorted(want) and all(
            torch.equal(sd[k].cpu(), src[k]) for k in want)
        cfg = trainer.cfg
        require(trainer.tokenizer.vocab_size == 2048
                and cfg.enc_time_reductions == () and cfg.input_size == 128
                and (cfg.enc_layers, cfg.enc_hidden_size) == (6, 1024),
                f'the raw trainer is not E6D2 on the FrontEnd: {cfg}')

        def batches():
            while True:
                yield from trainer.loader

        it = batches()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):                                  # warm-up
            float(trainer.run_step(next(it))['loss'])
        _reset_launches()
        times, audio_s, losses, shapes, measured = [], [], [], [], []
        for _ in range(3):
            batch = next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(trainer.run_step(batch)['loss']))
            times.append(time.perf_counter() - t1)
            audio_s.append(float(batch['alen'].sum()) / 16000.0)
            shapes.append([int(x) for x in batch['audio'].shape[1:]]
                          + [int(batch['ys'].shape[1]) + 1])
            measured.append(batch)
        STATE['launches_raw_train'] = _launches()
        STATE.setdefault('w2v_shapes', {})['raw_train'] = _raw_lattices(
            measured, trainer.accum_steps, trainer.FRONTEND_SPEC)
        n = trainer.accum_steps * len(times)
        layers = cfg.enc_layers + cfg.dec_layers
        expect = STATE.setdefault('run_expect', {})
        expect['raw_train'] = _expect(
            lstm_fwd=layers * n, lstm_bwd=layers * n, joint_lse_fwd=n,
            joint_lse_bwd=n, lattice_alpha=n, lattice_beta_grad=n)
        med = statistics.median(times)
        res = {'phase': 'raw_train_run',
               'config': 'flagfiles/E6D2.txt --use_pretrained (cli.train)',
               'params': sum(p.numel() for p in
                             trainer.state.model.parameters()),
               'batch_size': flags.batch_size, 'accum': trainer.accum_steps,
               'bf16': flags.bf16, 'setup_s': setup_s,
               'spliced_keys': len(copied), 'spliced_equal': spliced,
               'batch_samples_U1': shapes,
               'frames': [frontend_output_length(trainer.FRONTEND_SPEC,
                                                 s_[0]) for s_ in shapes],
               'step_ms': [1e3 * x for x in times],
               'step_ms_median': 1e3 * med,
               'audio_s_per_s_median': statistics.median(
                   a / x for a, x in zip(audio_s, times)),
               'losses': losses,
               'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
        res.update(_device_profile(torch, lambda: float(
            trainer.run_step(next(it))['loss']), 1, 'step'))
        it.close()

        # loss falls on a repeated small batch (fresh weights, lr 1e-3)
        small = {k: v[:4] for k, v in next(iter(trainer.loader)).items()}
        dev_small = device_batch(small, 1, trainer.device)
        model = RawTransducer(cfg, trainer.device, seed=1)
        state = TrainState(model, trainer.optimizer.init(
            dict(model.named_parameters())))
        fall = []
        for _ in range(10):
            state, m = trainer.train_step(state, dev_small, 1e-3,
                                          trainer.generator)
            fall.append(float(m['loss']))
        res['repeated_batch_losses'] = fall
        del state, model

        path = trainer.save()
        step = trainer.state.step
        del trainer
        lines = []
        _reset_launches()
        # the step by name: pretraining's best checkpoints share
        # logs/<name>/models/ with the fine-tune's (as in the JAX package)
        evaluated = CT.main(argv + ['--mode', 'eval', '--resume_step',
                                    str(step)], log_fn=lines.append)
        STATE['launches_raw_eval'] = _launches()
        n_eval = len(evaluated.eval_loader)
        expect['raw_eval'] = _expect(
            lstm_fwd=2 * layers * n_eval, greedy_decode=n_eval,
            joint_lse_fwd=n_eval, lattice_alpha=n_eval)
        STATE.setdefault('w2v_shapes', {})['raw_eval'] = _raw_lattices(
            list(evaluated.eval_loader), 1, evaluated.FRONTEND_SPEC)
        # the whole eval: wall and device ms a batch, its kernels' share
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        evaluated.evaluate()
        torch.cuda.synchronize()
        res['eval_wall_ms_per_batch'] = 1e3 * (time.perf_counter()
                                               - t1) / n_eval
        res.update({'eval_' + k: v for k, v in _device_profile(
            torch, evaluated.evaluate, n_eval, 'batch').items()})
        res['eval_kernel_device_ms_per_batch'] = {
            k: v / n_eval for k, v in kernel_split_ms(
                torch, evaluated.evaluate, EVAL_PARTS, n=1).items()}
        saved = load_checkpoint(path)['model']
        res['eval_reloaded_equal'] = path == checkpoint_path(
            evaluated.logdir, step) and all(
                torch.equal(v.cpu(), saved[k]) for k, v in
                evaluated.state.model.state_dict().items())
        val = [ln for ln in lines if ln.startswith('val_loss')]
        res['eval'] = val[0] if val else None
        res['eval_batches'] = n_eval
        del evaluated
        emit(res)
        require(spliced, 'the spliced FrontEnd / encoder differ from '
                         'pretrained.ckpt')
        require(all(np.isfinite(losses)), 'a fine-tune loss is not finite')
        require(fall[-1] < fall[0], f'loss did not fall: {fall}')
        require(bool(val) and np.isfinite(float(val[0].split()[1]))
                and val[0].split()[2] == 'WER'
                and np.isfinite(float(val[0].split()[3])),
                f'eval printed no finite val_loss and WER: {lines}')
        require(res['eval_reloaded_equal'],
                '--mode eval did not reload the saved run')
    finally:
        os.chdir(cwd)


def phase_wav2vec_kernels(torch):
    """Each kernel of the wav2vec runs against its plain version at the
    shapes those runs gave it (pretrain_run's and raw_train_run's batches,
    STATE['w2v_shapes']; seeded data, the lattice at the run's own xlen
    and ylen), after every other case: pretraining's encoder K1 / K4 fp32
    (H=1024, input 128) and its eval's K1; for each micro-batch shape of
    the fine-tune's measured steps the encoder K1 bf16 held step by step
    and K4 bf16 (input 128), the prediction net's K1 / K4 fp32 (H=256,
    T=U+1: the raw loss casts the features alone, so the prediction net
    keeps fp32 weights), K9 / K10 and K7 / K8 bf16; for each eval batch
    shape the encoder and prediction-net K1 fp32 (and the decode's
    priming step, T=1), K9, K7 fp32 and K3."""
    record, dev = STATE['record'], torch.device('cuda')
    fp32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.RandomState(14)
    shapes = STATE['w2v_shapes']
    emit({'phase': 'wav2vec_kernels', 'shapes': {
        run: [list(k) for k in cases] for run, cases in shapes.items()}})
    for b, t in shapes['pretrain']:
        lstm_fwd_case(torch, rng, dev, record, 1024, b, t, fp32,
                      n_in=FRONTEND_C)
        lstm_bwd_case(torch, rng, dev, record, 1024, b, t, fp32,
                      n_in=FRONTEND_C)
    for b, t in shapes['pretrain_eval']:
        lstm_fwd_case(torch, rng, dev, record, 1024, b, t, fp32)
    for (b, t, u1), (xlen, ylen) in shapes['raw_train'].items():
        bf16_forward_case(torch, rng, dev, record, 'LSTM', b, t, FRONTEND_C)
        lstm_bwd_case(torch, rng, dev, record, 1024, b, t, bf16,
                      n_in=FRONTEND_C)
        lstm_fwd_case(torch, rng, dev, record, 256, b, u1, fp32)
        lstm_bwd_case(torch, rng, dev, record, 256, b, u1, fp32)
        lattice_long_cases(torch, rng, dev, record, b, t, u1, xlen, ylen)
        joint_long_case(torch, rng, dev, record, b, t, u1, bf16)
    for (b, t, u1), (xlen, ylen) in shapes['raw_eval'].items():
        for hid, steps in ((1024, t), (256, u1), (256, 1)):
            lstm_fwd_case(torch, rng, dev, record, hid, b, steps, fp32)
        lattice_long_cases(torch, rng, dev, record, b, t, u1, xlen, ylen,
                           backward=False)
        joint_long_case(torch, rng, dev, record, b, t, u1, fp32)
        k3_long_case(torch, rng, dev, record, b, t)


# ---------------------------------------------------------------------------
# the trainer's one-card features, and a JAX package checkpoint on the card
# ---------------------------------------------------------------------------

FEATURE_STEPS = 5          # measured steps a turn
FEATURE_TURNS = ('prefetch', 'device_corpus', 'sync', 'sync',
                 'device_corpus', 'prefetch')
# torch.profiler kernel names of the training kernels (the substrings of
# cli/profile_train.py KERNELS): K8 is any of its launches
TRACE_KERNELS = {'K1': ('lstm_fwd',), 'K2': ('mel_power',),
                 'K4': ('lstm_bwd',), 'K7': ('joint_lse_fwd',),
                 'K8': ('joint_lse_bwd_h', 'joint_lse_bwd_dl',
                        'joint_lse_bwd_dh', 'joint_lse_bwd_dw',
                        'joint_lse_bwd_reduce'),
                 'K9': ('lattice_alpha',), 'K10': ('lattice_beta_grad',)}


def _train_expect(cfg, micro_steps):
    """Launches of micro_steps feature-Trainer micro-steps (LSTM)."""
    layers = (cfg.enc_layers + cfg.dec_layers) * micro_steps
    return _expect(lstm_fwd=layers, lstm_bwd=layers,
                   **dict.fromkeys(('mel_power', 'joint_lse_fwd',
                                    'joint_lse_bwd', 'lattice_alpha',
                                    'lattice_beta_grad'), micro_steps))


def _step_source(trainer, mode):
    """An endless generator of step thunks: 'prefetch' the host loader
    through Trainer.device_batches (page-locked batches copied one ahead
    on a side stream), 'device_corpus' the index loader gathered on the
    card, 'sync' Trainer.run_step on each host batch (a blocking copy)."""
    while True:
        if mode == 'sync':
            for batch in trainer.loader:
                yield lambda b=batch: trainer.run_step(b)
        else:
            for dev in trainer.device_batches(trainer._loader_batches()):
                yield lambda d=dev: trainer.run_device_step(d)


def _state_snapshot(trainer):
    """The trainer's model and optimizer state, copied to the host."""
    from edgedict_tpu_torch.checkpoint import _to_cpu
    return (_to_cpu(trainer.state.model.state_dict(), copy=True),
            _to_cpu(trainer.state.opt_state, copy=True))


def _tree_equal(torch, a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(torch, a[k], b[k])
                                        for k in a)
    return torch.equal(a, b)


def phase_train_features(torch):
    """The trainer's one-card features at E6D2 width (flagfiles/E6D2.txt,
    batch 32, bf16, BPE 2048) on train_run's corpus: --device_corpus (its
    size on the card, the host loader's index order over two epochs, its
    batches equal to the host loader's where they are gathered); measured
    turns of FEATURE_STEPS steps, P D S S D P (prefetch: the host loader
    copied one ahead; device corpus; sync: run_step's blocking copy), each
    turn timed whole from its first batch to a synchronise after its last
    step, with the busy share of 3 more steps and the peak memory of each
    mode; --profile_dir over 14 steps of Trainer.train (the chrome trace
    holds K1, K2, K4 and K7-K10 records); the background save of the full
    state (blocking ms against a synchronous save; the file equals the
    state at the save bit for bit after wait_for_checkpoints, and the step
    taken meanwhile is not in it)."""
    from edgedict_tpu_torch.checkpoint import (
        checkpoint_path, load_checkpoint, wait_for_checkpoints)
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.data import DataLoader
    from edgedict_tpu_torch.train import device_batch
    from edgedict_tpu_torch.trainer import IndexBatches, Trainer
    cwd = os.getcwd()
    tmp, base = _train_corpus()
    os.chdir(tmp)                 # the BPE-2048/ cache of the corpus
    try:
        argv = base + ['--name', 'e6d2-features']
        host = Trainer(parse_flags(baseline.build_parser(), argv))
        t0 = time.perf_counter()
        dc = Trainer(parse_flags(baseline.build_parser(),
                                 argv + ['--device_corpus']))
        corpus_s = time.perf_counter() - t0
        corpus = dc.device_corpus
        res = {'phase': 'train_features', 'config': 'flagfiles/E6D2.txt',
               'device_corpus_gb': sum(v.numel() * v.element_size()
                                       for v in corpus.values()) / 1e9,
               'device_corpus_audio_gb': corpus['audio'].numel()
               * corpus['audio'].element_size() / 1e9,
               'device_corpus_shape': list(corpus['audio'].shape)
               + [int(corpus['ys'].shape[1])],
               'device_corpus_setup_s': corpus_s}
        require(all(v.is_cuda for v in corpus.values()),
                'the device corpus is not on the card')
        require(isinstance(dc.loader, IndexBatches), 'no index loader')
        ref = DataLoader(dc.train_dataset, dc.flags.batch_size,
                         shuffle=True, drop_last=True)
        for epoch in range(2):
            want = [list(b) for b in ref._batches_indices()]
            ref.epoch += 1
            got = [list(b['idx']) for b in dc.loader]
            require(got == want, f'epoch {epoch}: the index order is not '
                                 "the host loader's")
        dc.loader.epoch = 0
        # uniform-length batches are the host loader's: check one whole
        idx = next(iter(dc.loader))['idx']
        dc.loader.epoch = 0
        gathered = dc.gather(idx)
        res['gather_checked'] = _gather_matches(torch, dc, host, idx,
                                                gathered)

        # turns P D S S D P
        trainers = {'prefetch': host, 'device_corpus': dc, 'sync': host}
        sources = {m: _step_source(t, m) for m, t in trainers.items()}
        for mode, src in sources.items():         # warm-up
            for _ in range(2):
                float(next(src)()['loss'])
        walls = {m: [] for m in sources}
        peak = dict.fromkeys(sources, 0.0)
        counts = {m: dict.fromkeys(SOURCES, 0) for m in sources}
        for mode in FEATURE_TURNS:
            src = sources[mode]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t1 = time.perf_counter()
            for _ in range(FEATURE_STEPS):
                m = next(src)()
            torch.cuda.synchronize()
            walls[mode].append(1e3 * (time.perf_counter() - t1)
                               / FEATURE_STEPS)
            for k, v in _launches().items():
                if k in counts[mode]:
                    counts[mode][k] += v
            peak[mode] = max(peak[mode],
                             torch.cuda.max_memory_allocated() / 1e9)
            require(np.isfinite(float(m['loss'])), f'{mode}: loss not finite')
        micro = host.accum_steps * FEATURE_STEPS * 2
        for mode in sources:
            STATE[f'launches_features_{mode}'] = counts[mode]
            STATE.setdefault('run_expect', {})[f'features_{mode}'] = \
                _train_expect(host.cfg, micro)
            res[mode] = {'step_ms_turns': walls[mode],
                         'step_ms_median': statistics.median(walls[mode]),
                         'peak_mem_gb': peak[mode]}
            res[mode].update(_device_profile(torch, lambda s=sources[mode]: [
                float(next(s)()['loss']) for _ in range(3)], 3, 'step'))
        for src in sources.values():
            src.close()

        # --profile_dir: 14 steps of Trainer.train
        prof_dir = os.path.join(tmp, 'profile')
        prof = Trainer(parse_flags(baseline.build_parser(), argv + [
            '--name', 'e6d2-profile', '--profile_dir', prof_dir]))
        _reset_launches()
        t1 = time.perf_counter()
        prof.train(total_steps=14, log_fn=lambda *_: 0)
        torch.cuda.synchronize()
        res['profile_train_s'] = time.perf_counter() - t1
        STATE['launches_features_profile'] = _launches()
        STATE['run_expect']['features_profile'] = _train_expect(
            prof.cfg, prof.accum_steps * 14)
        trace = os.path.join(prof_dir, 'trace_steps_11-13.json')
        require(os.path.isfile(trace), f'no chrome trace in {prof_dir}: '
                                       f'{os.listdir(prof_dir)}')
        res['profile_records'] = _trace_kernel_records(trace)
        del prof

        # background save of the full state, against a synchronous one
        res['save'] = _background_save(torch, host, checkpoint_path,
                                       load_checkpoint,
                                       wait_for_checkpoints)
        del host, dc
        emit(res)
        missing = [k for k, n in res['profile_records'].items() if not n]
        require(not missing, f'kernels missing from the trace: {missing}')
    finally:
        os.chdir(cwd)


def _gather_matches(torch, dc, host, idx, gathered):
    """The gathered batch against the host loader's collation of the same
    utterances (padded to the corpus's (L_max, U_max) instead of the
    batch's bucket: the valid parts and lengths must agree)."""
    from edgedict_tpu_torch.data.collate import seq_collate
    batch = seq_collate([dc.train_dataset[int(i)] for i in idx])
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])).cpu()
            for k, v in gathered.items()}
    require(torch.equal(flat['alen'], torch.as_tensor(batch['alen']))
            and torch.equal(flat['ylen'], torch.as_tensor(batch['ylen'])),
            'gathered lengths differ from the host batch')
    for i, (n, u) in enumerate(zip(batch['alen'], batch['ylen'])):
        require(torch.equal(flat['audio'][i, :n],
                            torch.as_tensor(batch['audio'][i, :n]))
                and torch.equal(flat['ys'][i, :u],
                                torch.as_tensor(batch['ys'][i, :u])),
                f'gathered utterance {i} differs from the host batch')
    return {'utterances': len(idx), 'L': int(flat['audio'].shape[1]),
            'host_L': int(batch['audio'].shape[1])}


def _trace_kernel_records(path):
    """{K#: kernel records of that kernel} in a torch.profiler chrome
    trace (names matched as cli/profile_train.py matches them)."""
    from edgedict_tpu_torch.cli.profile_train import KERNELS
    with open(path) as f:
        events = json.load(f).get('traceEvents', [])
    names = [e.get('name', '') for e in events
             if e.get('cat') == 'kernel']
    return {k: sum(1 for n in names if any(all(s in n for s in KERNELS[p])
                                           for p in parts))
            for k, parts in TRACE_KERNELS.items()}


def _background_save(torch, trainer, checkpoint_path, load_checkpoint,
                     wait_for_checkpoints):
    """Blocking ms of a synchronous and of a background save of the full
    state; the background file equals the state at its save bit for bit,
    and a step taken before wait_for_checkpoints is not in it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = trainer.save()
    sync_ms = 1e3 * (time.perf_counter() - t0)
    size = os.path.getsize(path)
    want_model, want_opt = _state_snapshot(trainer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bg_path = trainer.save(background=True)
    block_ms = 1e3 * (time.perf_counter() - t0)
    batch = next(iter(trainer.loader))
    float(trainer.run_step(batch)['loss'])          # while it writes
    t0 = time.perf_counter()
    wait_for_checkpoints()
    wait_ms = 1e3 * (time.perf_counter() - t0)
    payload = load_checkpoint(bg_path)
    same = (_tree_equal(torch, payload['model'], want_model)
            and _tree_equal(torch, payload['optim'], want_opt))
    after = {k: v.cpu() for k, v in trainer.state.model.state_dict().items()}
    leaked = _tree_equal(torch, payload['model'], after)
    os.remove(bg_path)
    res = {'bytes': size, 'sync_save_ms': sync_ms,
           'background_block_ms': block_ms,
           'wait_after_one_step_ms': wait_ms,
           'reload_bit_equal': same, 'next_step_in_file': leaked}
    require(bg_path == path == checkpoint_path(trainer.logdir,
                                               trainer.state.step - 1),
            'the background save wrote elsewhere')
    require(same, 'the background checkpoint differs from the state')
    require(not leaked, 'the step after the background save is in its file')
    return res


JAX_FIXTURE = os.path.join(REPO, 'tests', 'data', 'jax_ckpt')
JAX_TEXTS = ('HELLO WORLD', 'THE CAT SAT', 'A B C D', 'SPEECH TEST')


def phase_jax_checkpoint(torch):
    """A run trained and saved by the JAX package (the committed
    tests/data/jax_ckpt/: flax-msgpack 2.ckpt with Adam state, its flag
    snapshot and char tokenizer) on the card: cli.stream --device cuda
    --infer_dtype fp32 on the run directory (its decoder as the CLI builds
    it) emits the JAX package's token at every frame of the fixture's
    wav, and prints its transcript; cli.baseline --mode resume --device
    cuda takes step 3 from it on 12 seeded utterances (finite loss, the
    optimizer count at 3).  Launches: per chunk K2 and K3 once, K1 once
    per encoder layer; the step's micro-steps as train_run's.  The shapes
    of both runs' kernel calls are recorded as they run (_recorded_shapes)
    for phase_jax_kernels."""
    import contextlib
    import io
    import tempfile

    from edgedict_tpu_torch.cli import baseline, stream
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.data.audio_io import load_audio, save_wav
    with open(os.path.join(JAX_FIXTURE, 'expected.json')) as f:
        want = json.load(f)
    flagfile = os.path.join(JAX_FIXTURE, 'run', 'flagfile.txt')
    argv = ['--flagfile', flagfile, '--logdir_root', JAX_FIXTURE, '--name',
            'run', '--device', 'cuda', '--infer_dtype', 'fp32']
    flags = parse_flags(stream.build_parser('stream'), argv)
    flags.block_chunks = 1                  # cli.stream main's own flag
    decoder = stream.build_stream_decoder(flags)
    audio, _ = load_audio(os.path.join(JAX_FIXTURE, 'utt.wav'))
    shapes = STATE['jax_shapes'] = {'jax_stream': {}, 'jax_resume': {}}
    torch.cuda.synchronize()
    _reset_launches()
    with _recorded_shapes(shapes['jax_stream']):
        text = decoder.decode_wav(audio)
        torch.cuda.synchronize()
    STATE['launches_jax_stream'] = _launches()
    chunks = len(decoder.elapsed)
    cfg = decoder.cfg
    STATE.setdefault('run_expect', {})['jax_stream'] = _expect(
        lstm_fwd=cfg.enc_layers * chunks, mel_power=chunks,
        greedy_decode=chunks)
    frames = [int(t) for chunk in decoder.emitted for t in chunk]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stream.main(argv + ['--path', os.path.join(JAX_FIXTURE, 'utt.wav')])
    printed = out.getvalue().splitlines()

    tmp = tempfile.mkdtemp(prefix='edd_jax_', dir=_train_corpus()[0])
    logs = os.path.join(tmp, 'logs')
    shutil.copytree(JAX_FIXTURE, logs,
                    ignore=shutil.ignore_patterns('*.wav', '*.json'))
    d = os.path.join(tmp, 'libri', '1', '2')
    os.makedirs(d)
    rng = np.random.RandomState(3)
    lines = []
    for i in range(12):
        name = f'1-2-{i:04d}'
        save_wav(os.path.join(d, name + '.wav'),
                 0.3 * np.sin(np.arange(16000) * (0.05 + 0.01 * i))
                 + 0.05 * rng.randn(16000), 16000)
        lines.append(f'{name} {JAX_TEXTS[i % len(JAX_TEXTS)]}')
    with open(os.path.join(d, '1-2.trans.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    log = []
    _reset_launches()
    with _recorded_shapes(shapes['jax_resume']):
        trainer = baseline.main([
            '--flagfile', os.path.join(logs, 'run', 'flagfile.txt'),
            '--logdir_root', logs, '--LibriSpeech_train_100',
            os.path.join(tmp, 'libri'), '--mode', 'resume', '--loss_step',
            '1', '--device', 'cuda'], log_fn=log.append)
        torch.cuda.synchronize()
    STATE['launches_jax_resume'] = _launches()
    STATE['run_expect']['jax_resume'] = _train_expect(
        trainer.cfg, trainer.accum_steps)
    steps = [ln for ln in log if ln.startswith('step ')]
    res = {'phase': 'jax_checkpoint',
           'fixture': 'tests/data/jax_ckpt (tests/data/'
                      'make_jax_ckpt_fixture.py)',
           'chunks': chunks, 'frames': len(frames),
           'frames_equal': frames == want['frame_tokens'],
           'text': text, 'jax_text': want['text'], 'printed': printed,
           'resume_log': log, 'resume_step': trainer.state.step,
           'optimizer_count': int(trainer.state.opt_state['count']),
           'device': str(trainer.device)}
    emit(res)
    require(frames == want['frame_tokens'],
            f'cuda frame tokens differ from the JAX package\'s: {frames}')
    require(text == want['text'] and want['text'] in printed,
            f'cli.stream printed {printed}, the JAX package {want["text"]}')
    require('resumed from step 2' in log and len(steps) == 1
            and steps[0].startswith('step 3/3 loss ')
            and np.isfinite(float(steps[0].split()[3])),
            f'the resume did not take step 3: {log}')
    require(res['optimizer_count'] == 3 and trainer.device.type == 'cuda',
            f'optimizer count {res["optimizer_count"]} on {trainer.device}')


class _ShapeSpy:
    """Stands in for a kernel wrapper in the port's modules while a run
    goes: counts the call, keeps its shape key (and, from the key's first
    call, what that key's case needs: the key function's second result, a
    thunk or None, called then and only then), then calls the wrapper.  Its
    `launches` is the wrapper's own attribute, so the count that the
    wrapper keeps through its module's name is the same with the spy in
    place."""

    def __init__(self, fn, key, log):
        self.fn, self.key, self.log = fn, key, log
        log.update(calls=0, keys={})

    def __call__(self, *args, **kwargs):
        key, need = self.key(*args, **kwargs)
        self.log['calls'] += 1
        if key not in self.log['keys']:
            self.log['keys'][key] = need() if need else None
        return self.fn(*args, **kwargs)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, 'launches', n))
    # K11's count of its tiled launches (quant_matmul only)
    tile_launches = property(
        lambda self: self.fn.tile_launches,
        lambda self, n: setattr(self.fn, 'tile_launches', n))


def _spied(layer_widths=False, extra=False):
    """{name: (module, wrapper's name, call → (shape key, what its case
    needs))} of the kernels a JAX run launches: K1, K4, K2, K3, K7, K8,
    and the lattice core, whose forward launches K9 and backward K10 (it
    holds those two wrappers itself).  layer_widths: also the port's LSTM
    layer (ops/rnn.py lstm_layer_tm; no kernel), keyed (H, B, T, input
    width): the width of the cuDNN layer beside each K1 / K4 shape (with
    extra, the GRU layer's too, gru_layer_tm).  extra: also K5, K6, K11,
    K12 and K13 (the GRU and int8 kernels), keyed (H, B, T, dtype) and
    K11 (R, K, N, dtype)."""
    from edgedict_tpu_torch.ops import (
        decode_kernel, features_kernel, gru_kernel, joint_lse_kernel, quant,
        rnn, rnn_kernel, rnnt_loss_kernel)

    def lstm(x_proj, w_hh, h0, *rest):
        return (w_hh.shape[1], h0.shape[0], x_proj.shape[0],
                x_proj.dtype), None

    def joint(f, g, w_t, *rest):
        return (*f.shape[:2], g.shape[1], *w_t.shape, f.dtype), None

    def frames(cache, f, h_dec, hs, cs, blank, unk, emit_logp=False):
        return (f.shape[1], f.shape[0], emit_logp), lambda: (
            cache, f.clone(), h_dec.clone(), hs.clone(), cs.clone(), blank,
            unk, emit_logp)

    def lattice(blank_lp, label_lp, xlen, ylen):
        return tuple(blank_lp.shape), lambda: (xlen.cpu().numpy(),
                                               ylen.cpu().numpy())

    def layer(params, xs, state):
        # an int8 layer (w_hh_q) is keyed too: its K12 is keyed apart
        w_hh = params['w_hh'] if 'w_hh' in params else params['w_hh_q']
        return (w_hh.shape[1], *xs.shape[1::-1], xs.shape[2]), None

    spied = {'lstm_fwd': (rnn_kernel, 'lstm_recurrence', lstm),
             'lstm_bwd': (rnn_kernel, 'lstm_recurrence_bwd', lstm),
             'mel_power': (features_kernel, 'mel_power',
                           lambda audio, tables: (tuple(audio.shape),
                                                  lambda: tables)),
             'greedy_decode': (decode_kernel, 'greedy_frame_loop', frames),
             'joint_lse_fwd': (joint_lse_kernel, 'joint_lse_fwd', joint),
             'joint_lse_bwd': (joint_lse_kernel, 'joint_lse_bwd', joint),
             'lattice': (rnnt_loss_kernel, 'rnnt_loss_core', lattice)}
    if layer_widths:
        spied['lstm_layer'] = (rnn, 'lstm_layer_tm', layer)
    if layer_widths and extra:
        spied['gru_layer'] = (rnn, 'gru_layer_tm', layer)
    if extra:
        def gru(x_proj, w_hh, *rest):
            return (w_hh.shape[1], x_proj.shape[1], x_proj.shape[0],
                    x_proj.dtype), None

        def recur_q(h0):
            return lambda x_proj, *rest: ((
                rest[h0].shape[1], rest[h0].shape[0], x_proj.shape[0],
                x_proj.dtype), None)

        spied.update({
            'gru_fwd': (gru_kernel, 'gru_recurrence', gru),
            'gru_bwd': (gru_kernel, 'gru_recurrence_bwd', gru),
            'quant_matmul': (quant, 'quant_matmul', lambda x, wq, *rest: (
                (x.shape[0], x.shape[1], wq.shape[0], x.dtype), None)),
            'lstm_fwd_q': (quant, 'lstm_recurrence_q', recur_q(2)),
            'gru_fwd_q': (quant, 'gru_recurrence_q', recur_q(3))})
    return spied


def _port_modules():
    return [m for name, m in list(sys.modules.items())
            if m is not None and name.startswith('edgedict_tpu_torch')]


@contextlib.contextmanager
def _recorded_shapes(logs, layer_widths=False, extra=False):
    """Within: every name in the port's modules bound to a wrapper of
    _spied(layer_widths, extra) is bound to its _ShapeSpy, which fills
    logs[name]; on the way out every spy is unbound again, also from a
    module that was first imported within."""
    spies = {}
    for name, (mod, attr, key) in _spied(layer_widths, extra).items():
        fn = getattr(mod, attr)
        spies[id(fn)] = (fn, _ShapeSpy(fn, key, logs.setdefault(name, {})))
    try:
        for mod in _port_modules():
            for attr, val in list(vars(mod).items()):
                if id(val) in spies and spies[id(val)][0] is val:
                    setattr(mod, attr, spies[id(val)][1])
        yield
    finally:
        for mod in _port_modules():
            for attr, val in list(vars(mod).items()):
                if isinstance(val, _ShapeSpy):
                    setattr(mod, attr, val.fn)


def _legacy_shapes(run):
    """_recorded_shapes of one run of the ctc / legacy phases, into
    STATE['legacy_shapes'][run], with the LSTM layers' input widths."""
    return _recorded_shapes(
        STATE.setdefault('legacy_shapes', {}).setdefault(run, {}),
        layer_widths=True)


def phase_jax_kernels(torch):
    """Each kernel that jax_checkpoint's two runs launched against its
    plain version at the shapes those runs gave it (STATE['jax_shapes'],
    recorded as they ran; the fixture's H=16 encoder and prediction net,
    its char vocabulary of 22, J=16, 2 s utterances): recorded_cases."""
    recorded_cases(torch, 'jax_kernels', STATE['jax_shapes'],
                   np.random.RandomState(15))


def recorded_cases(torch, phase, shapes, rng, seen=None, groups=None):
    """Each kernel of each run in shapes ({run: _recorded_shapes' logs})
    against its plain version at the shapes that run gave it, on card
    tensors, at the tolerances of the E6D2 cases: K1 fp32 (lstm_fwd_case)
    and bf16 held step by step (bf16_forward_case), K4 (lstm_bwd_case), K2
    through the run's own mel tables (mel_case), K3 on the first call's
    own arguments (k3_check), K7 / K8 on seeded data at the run's J and V
    (joint_long_case: bf16 padded onto 16), K9 / K10 on seeded log-probs
    at the run's own lengths (lattice_long_cases).  First each run's
    recorded calls are held against its launch counts: the spies saw every
    launch.  Where recorded (_spied's extra), also K5 (bf16 held step by
    step, fp32 by recurrence_case), K6 (gru_bwd_case), K11
    (quant_matmul_case), K12 and K13 (recurrence_case); where the LSTM
    layers' input widths were recorded (layer_widths), K1 / K4 beside one
    cuDNN layer of that width.  seen: a set of (kernel, key) already held,
    skipped here and added to (runs that share shapes).  groups: {kernel:
    key → group}; of the keys of one group only the first is timed, the
    others are checked untimed()."""
    record, dev = STATE['record'], torch.device('cuda')
    bf16 = torch.bfloat16
    timed_groups = set()
    readable = {run: {name: [[str(x) for x in key] for key in log['keys']]
                      for name, log in logs.items()}
                for run, logs in shapes.items()}
    emit({'phase': phase, 'shapes': readable})
    for run, logs in shapes.items():
        n = STATE['launches_' + run]
        calls = {name: log['calls'] for name, log in logs.items()
                 if name not in ('lstm_layer', 'gru_layer')}
        want = {name: n.get(name, n['lattice_alpha']) for name in calls}
        require(calls == want and n['lattice_beta_grad'] <= calls['lattice'],
                f'{run}: recorded calls {calls}, launches {n}')
        widths = {key[:3]: key[3] for key in
                  logs.get('lstm_layer', {}).get('keys', ())}
        gru_widths = {key[:3]: key[3] for key in
                      logs.get('gru_layer', {}).get('keys', ())}

        def keys(name):
            """(key, its timing context) of the run's keys of `name` that
            `seen` has not had: untimed() where `groups` puts a key in a
            group an earlier key of this call timed."""
            out = []
            for key in logs.get(name, {}).get('keys', ()):
                if seen is not None and (name, key) in seen:
                    continue
                if seen is not None:
                    seen.add((name, key))
                ctx = contextlib.nullcontext()
                if groups and name in groups:
                    group = (name, groups[name](key))
                    if group in timed_groups:
                        ctx = untimed()
                    timed_groups.add(group)
                out.append((key, ctx))
            return out

        for (hid, b, t, dt), ctx in keys('lstm_fwd'):
            with ctx:
                if dt == bf16:
                    bf16_forward_case(torch, rng, dev, record, 'LSTM', b, t,
                                      widths.get((hid, b, t)), hid=hid)
                else:
                    lstm_fwd_case(torch, rng, dev, record, hid, b, t, dt,
                                  n_in=widths.get((hid, b, t)))
        for (hid, b, t, dt), ctx in keys('lstm_bwd'):
            with ctx:
                lstm_bwd_case(torch, rng, dev, record, hid, b, t, dt,
                              n_in=widths.get((hid, b, t)))
        for (b, length), ctx in keys('mel_power'):
            with ctx:
                mel_case(torch, rng, dev, record,
                         logs['mel_power']['keys'][(b, length)], b, length)
        for key, ctx in keys('greedy_decode'):
            with ctx:
                k3_check(torch, record, logs['greedy_decode']['keys'][key],
                         run=run)
        require(all(k in logs['joint_lse_fwd']['keys'] and k[-1] == bf16
                    for k in logs['joint_lse_bwd']['keys']),
                f'{run}: a K8 call without its bf16 K7 case')
        for (b, t, u1, j, v, dt), ctx in keys('joint_lse_fwd'):
            with ctx:
                joint_long_case(torch, rng, dev, record, b, t, u1, dt, j, v)
        for (b, t, u1), ctx in keys('lattice'):
            xlen, ylen = logs['lattice']['keys'][(b, t, u1)]
            with ctx:
                lattice_long_cases(torch, rng, dev, record, b, t, u1, xlen,
                                   ylen, backward=n['lattice_beta_grad'] > 0)
        for (hid, b, t, dt), ctx in keys('gru_fwd'):
            with ctx:
                if dt == bf16:
                    bf16_forward_case(torch, rng, dev, record, 'GRU', b, t,
                                      gru_widths.get((hid, b, t)), hid=hid)
                else:
                    recurrence_case(torch, rng, dev, record, 'gru_fwd', hid,
                                    b, t, dt,
                                    n_in=gru_widths.get((hid, b, t)))
        for (hid, b, t, dt), ctx in keys('gru_bwd'):
            with ctx:
                gru_bwd_case(torch, rng, dev, record, hid, b, t, dt,
                             n_in=gru_widths.get((hid, b, t)))
        for (r, k, n_out, dt), ctx in keys('quant_matmul'):
            with ctx:
                quant_matmul_case(torch, rng, dev, record, r, k, n_out, dt)
        for name, w in (('lstm_fwd_q', widths), ('gru_fwd_q', gru_widths)):
            for (hid, b, t, dt), ctx in keys(name):
                with ctx:
                    recurrence_case(torch, rng, dev, record, name, hid, b, t,
                                    dt, n_in=w.get((hid, b, t)))



# ---------------------------------------------------------------------------
# export and the streaming apps
# ---------------------------------------------------------------------------

# the op of each edgedict graph node: (counter name, plain version's
# module, its name)
EXPORT_OPS = {'edgedict.lstm_fwd.default': ('lstm_fwd', 'rnn_kernel',
                                            'lstm_recurrence_plain'),
              'edgedict.quant_matmul.default': ('quant_matmul', 'quant',
                                                'quant_matmul_plain'),
              'edgedict.lstm_fwd_q.default': ('lstm_fwd_q', 'quant',
                                              'lstm_recurrence_q_plain')}


def _graph_op_shapes(path):
    """{(op, ((shape, dtype) of each argument))} of the edgedict nodes of
    a saved graph: the shapes its op calls launch with (static)."""
    import torch
    out = set()
    for node in torch.export.load(path).graph.nodes:
        if node.op == 'call_function' and str(node.target) in EXPORT_OPS:
            out.add((str(node.target), tuple(
                (tuple(a.meta['val'].shape), str(a.meta['val'].dtype))
                for a in node.args)))
    return out


def _export_op_case(torch, record, op, specs):
    """One edgedict op on seeded card tensors of its graph node's shapes
    against its plain version on the same tensors: fp32 to atol 1e-4 rtol
    1e-4 (K11: 1e-5 of max(1, |out|)), as phase 3 holds these kernels."""
    import importlib
    from edgedict_tpu_torch.ops import quant as Q
    name, mod, plain = EXPORT_OPS[op]
    plain = getattr(importlib.import_module('edgedict_tpu_torch.ops.' + mod),
                    plain)
    rng = np.random.RandomState(len(specs) + sum(s[0][-1] for s in specs))
    dev = torch.device('cuda')

    def t_(shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale)
                               .astype(np.float32), device=dev)
    (x_shape, _), (w_shape, _) = specs[0], specs[1]
    if name == 'lstm_fwd':
        args = (t_(x_shape), t_(w_shape, w_shape[1] ** -0.5),
                t_(specs[2][0], 0.5), t_(specs[3][0], 0.5))
    else:
        q, sc = Q.quantize_int8(t_(w_shape, w_shape[1] ** -0.5))
        args = ((t_(x_shape), q, sc, t_(specs[3][0], 0.1))
                if name == 'quant_matmul' else
                (t_(x_shape), q, sc, t_(specs[3][0], 0.5),
                 t_(specs[4][0], 0.5)))
    got = getattr(torch.ops.edgedict, op.split('.')[1])(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name == 'quant_matmul':
        err = _rel(torch, got[0], want[0])
        ok = err <= 1e-5
    else:
        oks, errs = zip(*[_close(g, w, 1e-4, 1e-4)
                          for g, w in zip(got, want)])
        ok, err = all(oks), max(errs)
    case = {'kernel': f'{name} (edgedict op, export graph)',
            'shapes': [list(s) for s, _ in specs], 'max_err': err}
    emit(case)
    require(ok, f'{op} disagrees with its plain version: {case}')
    record(name, err)


def _export_decode(dec, audio, win, hop):
    """The exported decoder over every chunk of `audio` after a reset →
    text."""
    dec.reset()
    dec.reset_profile()
    n = (len(audio) - win) // hop + 1
    return ''.join(dec.decode(audio[i * hop:i * hop + win]) for i in range(n))


def _op_dispatch_us(torch, n=300):
    """Host µs a call of the edgedict::lstm_fwd op adds over calling its
    CUDA implementation directly, at the B=1 chunk's encoder layer (H=1024
    B=1 T=2 fp32), each timed over n enqueues after a warm-up, in turns
    direct, op, op, direct → (op µs, direct µs)."""
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    rng = np.random.RandomState(4)
    dev = torch.device('cuda')
    xp = torch.as_tensor(rng.randn(2, 1, 4096).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.randn(4096, 1024).astype(np.float32) / 32,
                        device=dev)
    h0 = torch.zeros((1, 1024), device=dev)
    fns = {'direct': lambda: K1._lstm_fwd_kernel(xp, w, h0, h0),
           'op': lambda: torch.ops.edgedict.lstm_fwd(xp, w, h0, h0)}
    times = {k: [] for k in fns}
    for key in ('direct', 'op', 'op', 'direct'):
        fns[key]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fns[key]()
        times[key].append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return (float(np.mean(times['op'])), float(np.mean(times['direct'])))


def phase_export(torch):
    """export_transducer at E6D2 (the slice's seeded weights) on cuda, fp32
    and int8, with its parity checks; the ExportedStreamDecoder over the
    slice's 4 s == the live StreamingDecoder on cuda text for text (the
    stand-in tokenizer has one character per id; fp32 with TF32 off; int8
    against live int8), the launches of the measured exported decode
    (exactly: per chunk K2 once and the encoder's K1 per layer, int8 K11
    per layer and for the projection and K12 per layer; the prediction
    net's K1 per layer for the reset's BOS step and every non-blank
    frame; no K3), each graph's
    edgedict op nodes (one per layer) and each op held against its plain
    version on card tensors of its node's shapes; artifact bytes, the
    exported and live chunk ms, and the host µs of one op dispatch over a
    direct call of K1's implementation."""
    import tempfile

    from edgedict_tpu_torch import export as E
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.stream import detokenize, stream_chunk_geometry
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model, record = STATE['model'], STATE['record']
    audio = synthetic_audio(0)
    win, hop = stream_chunk_geometry(feat.win_length, feat.hop_length,
                                     feat.downsample, 2)
    tmp = tempfile.mkdtemp(prefix='edd_export_', dir=_train_corpus()[0])
    res = {'phase': 'export', 'config': 'flagfiles/E6D2.txt',
           'weights': 'random, seed 0 (the slice\'s)'}
    for quantize in (None, 'int8'):
        tag = quantize or 'fp32'
        t0 = time.perf_counter()
        out = E.export_transducer(model, cfg, os.path.join(tmp, tag),
                                  quantize=quantize, device='cuda')
        export_s = time.perf_counter() - t0
        dec = E.ExportedStreamDecoder(out, FeaturePipeline(feat, 'cuda'),
                                      tok, device='cuda')
        _export_decode(dec, audio, win, hop)                  # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        text = _export_decode(dec, audio, win, hop)
        torch.cuda.synchronize()
        run = 'export' + ('_int8' if quantize else '')
        STATE['launches_' + run] = _launches()
        live, live_tok = _decode(model, cfg, feat, tok, audio, 'cuda',
                                 quantize=quantize)
        live_text = detokenize(tok, live_tok)
        chunks = len(dec.elapsed)
        emitting = int((live_tok != cfg.blank).sum())
        enc = {'lstm_fwd': cfg.enc_layers * chunks} if not quantize else {
            'quant_matmul': (cfg.enc_layers + 1) * chunks,
            'lstm_fwd_q': cfg.enc_layers * chunks}
        expect = dict(enc, mel_power=chunks)
        # the prediction net: the reset's BOS step, then one step for
        # every non-blank frame
        expect['lstm_fwd'] = expect.get('lstm_fwd', 0) \
            + cfg.dec_layers * (1 + emitting)
        STATE.setdefault('run_expect', {})[run] = _expect(**expect)
        graphs = {name: _graph_op_shapes(os.path.join(out, f'{name}.pt2'))
                  for name in E.COMPONENTS}
        sizes = {name: os.path.getsize(os.path.join(out, f'{name}.pt2'))
                 for name in E.COMPONENTS}
        res[tag] = {
            'export_s': export_s, 'artifact_bytes': sizes,
            'chunks': chunks, 'emitting_frames': emitting,
            'text_equals_live': text == live_text, 'text_chars': len(text),
            'chunk_ms_exported': 1e3 * float(np.mean(dec.elapsed)),
            'chunk_ms_live': 1e3 * float(np.mean(live.elapsed)),
            'launches': {k: v for k, v in STATE['launches_' + run].items()
                         if v},
            'graph_ops': {name: sorted({op for op, _ in g})
                          for name, g in graphs.items()}}
        emit({'phase': 'export', 'variant': tag, **res[tag]})
        require(text == live_text and text,
                f'{tag}: the exported decoder\'s text differs from the live '
                f'decoder\'s (or is empty)')
        require(STATE['launches_' + run] == STATE['run_expect'][run],
                f'{tag}: exported decode launches '
                f'{STATE["launches_" + run]} != {STATE["run_expect"][run]}')
        for op, specs in sorted(set().union(*graphs.values())):
            _export_op_case(torch, record, op, specs)
    res['encoder_bytes_int8_over_fp32'] = \
        res['int8']['artifact_bytes']['encoder'] / \
        res['fp32']['artifact_bytes']['encoder']
    res['op_dispatch_us'], res['direct_call_us'] = _op_dispatch_us(torch)
    emit({key: res[key] for key in ('phase', 'config', 'weights',
                                    'encoder_bytes_int8_over_fp32',
                                    'op_dispatch_us', 'direct_call_us')})
    require(res['encoder_bytes_int8_over_fp32'] < 0.55,
            'the int8 encoder artifact is not under 0.55x the fp32 one')


@contextlib.contextmanager
def _timed_eval_steps():
    """Within: every eval step that train.make_eval_step makes is timed
    (wall ms, between device synchronises) into the yielded list."""
    import torch
    from edgedict_tpu_torch import train
    real, times = train.make_eval_step, []

    def make_timed(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(model, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(model, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    train.make_eval_step = make_timed
    try:
        yield times
    finally:
        train.make_eval_step = real


def phase_apps(torch):
    """The apps on the card at E6D2 (the slice's seeded weights saved as a
    reference-layout .pt; train_run's eval corpus, 8 utterances of 8-16 s,
    and its BPE 2048): cli.wer_parity --max_batches 1 --eval_batch_size 4
    on cuda (its launches exactly what one eval batch implies) == the same
    on the CPU, hypothesis for hypothesis, and its JSON line; cli.export
    --pt_path of the .pt, then cli.wav_inference --backends
    jit,exported,int8 --per_stage --infer_dtype fp32 on 4 utterances (jit
    == exported hypothesis for hypothesis; K1, K2, K3, K11, K12 launched);
    cli.youtube_live --wav on the first: '[jit]' == '[exported]'; the
    eval step's wall ms a batch on each device."""
    import io

    from edgedict_tpu_torch.cli import (
        export as export_cli, wav_inference, wer_parity, youtube_live)
    tmp, _ = _train_corpus()
    pt = os.path.join(tmp, 'e6d2_seed0.pt')
    torch.save({'model': STATE['model'].state_dict()}, pt)
    test = os.path.join(tmp, 'test')
    common = [f'--flagfile={REPO}/flagfiles/E6D2.txt', '--pt_path', pt]
    cwd = os.getcwd()
    os.chdir(tmp)                 # the BPE-2048/ cache of the corpus
    try:
        res = {'phase': 'apps'}
        wer_argv = common + ['--LibriSpeech_test', test, '--max_batches',
                             '1', '--eval_batch_size', str(EVAL_BATCH)]
        hyps, out = {}, io.StringIO()
        for device in ('cuda', 'cpu'):
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), _timed_eval_steps() as ms:
                result, hyps[device] = wer_parity.main(
                    wer_argv + ['--device', device])
            torch.cuda.synchronize()
            res[f'wer_parity_{device}_s'] = time.perf_counter() - t0
            res[f'wer_parity_{device}_batch_ms'] = ms
            if device == 'cuda':
                STATE['launches_wer_parity'] = _launches()
        cfg, _ = _e6d2()
        STATE.setdefault('run_expect', {})['wer_parity'] = _expect(
            mel_power=1, greedy_decode=1, joint_lse_fwd=1, lattice_alpha=1,
            lstm_fwd=2 * (cfg.enc_layers + cfg.dec_layers))
        res['wer_parity_lines'] = out.getvalue().splitlines()
        res['wer_parity_hyps_equal'] = hyps['cuda'] == hyps['cpu']
        res['wer_parity_hyp_words'] = [len(h.split()) for h in hyps['cuda']]
        emit(res)
        require(res['wer_parity_hyps_equal'],
                'wer_parity: cuda hypotheses differ from the CPU\'s')
        require(len(hyps['cuda']) == EVAL_BATCH
                and json.loads(res['wer_parity_lines'][-1])['n_utts']
                == EVAL_BATCH, f'wer_parity: {res["wer_parity_lines"]}')
        require(STATE['launches_wer_parity'] ==
                STATE['run_expect']['wer_parity'],
                f'wer_parity launches {STATE["launches_wer_parity"]}')

        run = ['--logdir_root', os.path.join(tmp, 'logs'), '--name',
               'apps', '--device', 'cuda']
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            export_cli.main(common + run)
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            backends = wav_inference.main(
                common + run + ['--wav_dir', test, '--n_samples', '4',
                                '--backends', 'jit,exported,int8',
                                '--per_stage', '--infer_dtype', 'fp32'])
        torch.cuda.synchronize()
        wav_s = time.perf_counter() - t0
        launched = _launches()
        wav = sorted(os.path.join(test, '1', '1', f) for f in
                     os.listdir(os.path.join(test, '1', '1'))
                     if f.endswith('.wav'))[0]
        lines = out.getvalue().splitlines()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            youtube_live.main(common + run + ['--wav', wav,
                                              '--infer_dtype', 'fp32'])
        ab = dict(ln.split(' ', 1) for ln in out.getvalue().splitlines()
                  if ln.startswith(('[jit] ', '[exported] ')))
        res = {'phase': 'apps', 'wav_inference_s': wav_s,
               'wav_inference_lines': [ln for ln in lines if ln.startswith(
                   ('[jit', '[int8', '[exported', 'benchmarking',
                    'exported '))],
               'wav_inference_launches': {k: v for k, v in launched.items()
                                          if v},
               'jit_equals_exported': backends['jit'][2]
               == backends['exported'][2],
               'youtube_live_ab_equal': ab.get('[jit]') == ab.get(
                   '[exported]') and '[jit]' in ab,
               'youtube_live_chars': len(ab.get('[jit]', ''))}
        emit(res)
        require(res['jit_equals_exported'],
                'wav_inference: exported hypotheses differ from jit')
        require(all(launched[k] > 0 for k in (
            'lstm_fwd', 'mel_power', 'greedy_decode', 'quant_matmul',
            'lstm_fwd_q')), f'wav_inference launches {launched}')
        require(res['youtube_live_ab_equal'],
                f'youtube_live --wav: {ab}')
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# the CTC model, the legacy v1 models and the spline time warp
# ---------------------------------------------------------------------------

CTC_BATCH = 32
CTC_STEPS = 5              # measured Adam steps (after one warm-up step)
LEGACY_BATCH = 8           # the legacy joint's fp32 hidden is B·T·(U+1)·H
LEGACY_STACK = 3           # MFCC_ frames stacked (ConcatFeature)
PREFIX_BEAM = 8
SPLINE_W = 80              # the legacy TimeWrap's warp parameter
LEGACY_CHARS = 15.0        # characters a second of the synthetic texts


def _utterances(torch, seed, n, lo=8.0, hi=16.0):
    """n seeded synthetic utterances of lo..hi s → (audio (n, L) fp32
    zero-padded, lengths (n,) int64), on the CPU."""
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    rng = np.random.RandomState(seed)
    clips = [synthetic_audio(seed + i, rng.uniform(lo, hi))
             for i in range(n)]
    audio = np.zeros((n, max(len(c) for c in clips)), np.float32)
    for i, c in enumerate(clips):
        audio[i, :len(c)] = c
    return (torch.from_numpy(audio),
            torch.tensor([len(c) for c in clips], dtype=torch.int64))


def _grad_rel(torch, got, want):
    """max over tensors of max|got - want| / max|want|."""
    return max(float((got[k] - g).abs().max())
               / max(1e-30, float(g.abs().max())) for k, g in want.items())


def _loss_and_grads(torch, model, loss_fn, *args):
    model.zero_grad()
    loss = loss_fn(model, *args)
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()}


def _token_gap(torch, logp_cpu, frame):
    """The CPU's top-two log-prob gap at (batch row, frame)."""
    top = torch.topk(logp_cpu[frame], 2).values
    return float(top[0] - top[1])


def phase_ctc(torch):
    """The CTC model (models/ctc.py) at the JAX defaults: 4 x 600 LSTM,
    projection 600, a time reduction after layer 1, input 240 (E6D2's 80
    log-mels stacked 3 times, featurized by the port's pipeline on the
    card), V=2048 as BPE-2048, batch 32 of 8-16 s synthetic utterances.
    (1) One fp32 loss + gradient on cuda against the CPU port on the same
    weights and batch (item 0's labels need more frames than it has: the
    optax recursion's finite loss): each utterance's loss (ctc_losses on
    the log-probs of a second forward) 1e-5 rel, the mean as a summary,
    each gradient 1e-3 of its max.  (2) Greedy decode on cuda (TF32 off)
    == the CPU's, tokens exact.  (3) Adam (the port's optim.py, lr 1e-3) in bf16 on the batch
    with item 0's labels cut to fit: one warm-up step, then CTC_STEPS
    measured (median step ms, audio s/s), the loss falling.  Launches:
    K1 and K4 once per encoder layer a step, K1 per layer a decode; the
    shapes are recorded (_recorded_shapes) for phase_legacy_kernels."""
    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.models import ctc as C
    from edgedict_tpu_torch.models.transducer import scale_length
    from edgedict_tpu_torch.optim import Optimizer
    dev = torch.device('cuda')
    _, fcfg = _e6d2()
    audio, alen = _utterances(torch, 160, CTC_BATCH)
    with torch.no_grad():
        xs, xlen = F.FeaturePipeline(fcfg, dev)(audio.to(dev), alen.to(dev))
    STATE['ctc_feats'] = xs
    cfg = C.CTCConfig(vocab_size=2048, input_size=fcfg.input_size)
    require(cfg.input_size == 240 and (cfg.enc_layers, cfg.enc_hidden_size,
                                       cfg.enc_proj_size) == (4, 600, 600),
            f'CTC config {cfg}')
    model = C.CTCModel(cfg, dev, seed=0)
    cpu = C.CTCModel(cfg, 'cpu', seed=0)
    t_enc = -(-xs.shape[1] // 2)
    xlen_s = scale_length(cfg.encoder_cfg, xlen, xs.shape[1], t_enc).cpu()
    rng = np.random.RandomState(161)
    ylen = (alen.numpy() / 16000 * 3.5).astype(np.int64)   # ~BPE-2048
    ylen[0] = int(xlen_s[0]) + 20                           # infeasible
    ys = rng.randint(4, cfg.vocab_size, (CTC_BATCH, ylen.max()))
    ys[np.arange(ys.shape[1])[None] >= ylen[:, None]] = 0
    ys, ylen = torch.from_numpy(ys), torch.from_numpy(ylen)
    need = C.ctc_frames_needed(ys, ylen)
    require(bool(need[0] > xlen_s[0]) and bool((need[1:] <= xlen_s[1:]).all()),
            'the CTC batch should hold exactly one infeasible item')
    expect = STATE.setdefault('run_expect', {})
    on = [a.to(dev) for a in (ys, xlen, ylen)]

    _reset_launches()
    with _legacy_shapes('ctc_parity'):
        t0 = time.perf_counter()
        l_gpu, g_gpu = _loss_and_grads(torch, model, C.ctc_loss, xs, *on)
        torch.cuda.synchronize()
        parity_ms = (time.perf_counter() - t0) * 1e3
    STATE['launches_ctc_parity'] = _launches()
    expect['ctc_parity'] = _expect(lstm_fwd=cfg.enc_layers,
                                   lstm_bwd=cfg.enc_layers)
    t0 = time.perf_counter()
    l_cpu, g_cpu = _loss_and_grads(torch, cpu, C.ctc_loss, xs.cpu(), ys,
                                   xlen.cpu(), ylen)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    grad_rel = _grad_rel(torch, g_gpu, g_cpu)
    # each utterance's loss (the infeasible item's ~1e5 would set the mean)
    per_utt = []
    with torch.no_grad():
        for m, x, args in ((model, xs, on), (cpu, xs.cpu(),
                                             (ys, xlen.cpu(), ylen))):
            logp = C.ctc_apply(m, x)
            xl = scale_length(cfg.encoder_cfg, args[1], x.shape[1],
                              logp.shape[1])
            per_utt.append(C.ctc_losses(logp, xl, args[0], args[2],
                                        cfg.blank).cpu())
    utt_rel = ((per_utt[0] - per_utt[1]).abs() / per_utt[1].abs()).numpy()

    _reset_launches()
    with torch.no_grad(), _legacy_shapes('ctc_decode'):
        seqs_gpu, neg_gpu = C.ctc_greedy_decode(model, xs, xlen)
        torch.cuda.synchronize()
    STATE['launches_ctc_decode'] = _launches()
    expect['ctc_decode'] = _expect(lstm_fwd=cfg.enc_layers)
    with torch.no_grad():
        seqs_cpu, neg_cpu = C.ctc_greedy_decode(cpu, xs.cpu(), xlen.cpu())
    differ = [i for i, (a, b) in enumerate(zip(seqs_gpu, seqs_cpu))
              if not np.array_equal(a, b)]

    # Adam in bf16 on the batch whose item 0 fits its frames
    ylen_t = ylen.clone()
    ylen_t[0] = int(xlen_s[0]) // 2
    train = [xs.to(torch.bfloat16), ys.to(dev), xlen, ylen_t.to(dev)]
    opt = Optimizer('adam')
    params = dict(model.named_parameters())
    ostate = [opt.init(params)]

    def step():
        model.zero_grad()
        loss = C.ctc_loss(model, *train)
        loss.backward()
        updates, ostate[0] = opt.update(
            {k: p.grad for k, p in params.items()}, ostate[0], params, 1e-3)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        return loss.detach()

    losses = [step().item()]                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    _reset_launches()
    with _legacy_shapes('ctc_train'):
        for _ in range(CTC_STEPS):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
    STATE['launches_ctc_train'] = _launches()
    expect['ctc_train'] = _expect(lstm_fwd=cfg.enc_layers * CTC_STEPS,
                                  lstm_bwd=cfg.enc_layers * CTC_STEPS)
    step_ms = statistics.median(times)
    res = {'phase': 'ctc', 'B': CTC_BATCH, 'T': xs.shape[1],
           'T_enc': t_enc, 'U_max': int(ylen.max()),
           'audio_s': float(alen.sum()) / 16000,
           'infeasible_items': 1, 'loss_cuda': l_gpu, 'loss_cpu': l_cpu,
           'loss_rel': abs(l_gpu - l_cpu) / abs(l_cpu),
           'utt_loss_max_rel': float(utt_rel.max()),
           'utt_loss_max_rel_feasible': float(utt_rel[1:].max()),
           'utt_loss_infeasible': float(per_utt[1][0]),
           'grad_max_rel': grad_rel, 'parity_step_ms_cuda': parity_ms,
           'parity_step_ms_cpu': cpu_ms,
           'tokens_equal': not differ, 'rows_differing': differ,
           'emitted_tokens': int(sum(len(s) for s in seqs_gpu)),
           'neg_logp_rel': float(np.abs(neg_gpu - neg_cpu).max()
                                 / np.abs(neg_cpu).max()),
           'bf16_losses': losses, 'step_ms': step_ms, 'step_ms_all': times,
           'audio_s_per_s': float(alen.sum()) / 16000 / step_ms * 1e3,
           'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
           'bounds': 'each utterance\'s loss 1e-5 rel, each grad 1e-3 '
                     'of its max, tokens '
                     'exact, neg_logp 1e-4 rel, bf16 loss falling'}
    if differ:
        with torch.no_grad():
            logp = C.ctc_apply(cpu, xs.cpu())
        i = differ[0]
        res['first_row_top2_gaps'] = sorted(
            _token_gap(torch, logp[i], f) for f in range(int(xlen_s[i])))[:3]
    emit(res)
    require(res['utt_loss_max_rel'] <= 1e-5 and grad_rel <= 1e-3,
            'the CTC loss or its gradients on cuda differ from the CPU')
    require(not differ and res['neg_logp_rel'] <= 1e-4,
            f'CTC greedy decode on cuda differs from the CPU in rows {differ}')
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f'CTC bf16 Adam steps did not lower the loss: {losses}')


def _legacy_batch(torch, dev, tok):
    """LEGACY_BATCH synthetic utterances of 8-16 s → MFCC_ with CMVN
    (legacy_mfcc, normalize=True) per utterance on the card, each against
    the CPU's; stacked LEGACY_STACK frames (ConcatFeature) → (xs (B, T,
    120), xlen); labels: LegacyCharTokenizer ids of LEGACY_CHARS random
    characters a second (BOS dropped) → (ys, ylen); and the MFCCs' largest
    error relative to each utterance's largest magnitude."""
    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.models import legacy as L
    audio, alen = _utterances(torch, 170, LEGACY_BATCH)
    feats, errs = [], []
    for a, n in zip(audio, alen):
        m = L.legacy_mfcc(a[:n].to(dev), normalize=True)
        ref = L.legacy_mfcc(a[:n], normalize=True)
        errs.append(float((m.cpu() - ref).abs().max() / ref.abs().max()))
        feats.append(m)
    t = max(f.shape[0] for f in feats)
    mfcc = torch.zeros((len(feats), t, feats[0].shape[1]), device=dev)
    for i, f in enumerate(feats):
        mfcc[i, :f.shape[0]] = f
    lens = torch.tensor([f.shape[0] for f in feats], device=dev)
    xs, xlen = F.downsample_stack(mfcc, lens, LEGACY_STACK)
    rng = np.random.RandomState(171)
    chars = list('abcdefghijklmnopqrstuvwxyz      .,\'0123456789')
    ids = [tok.encode(''.join(rng.choice(chars, int(n / 16000
                                                   * LEGACY_CHARS))))[1:]
           for n in alen.numpy()]
    ylen = torch.tensor([len(i) for i in ids])
    ys = torch.zeros((len(ids), int(ylen.max())), dtype=torch.int64)
    for i, row in enumerate(ids):
        ys[i, :len(row)] = torch.tensor(row)
    return xs, xlen, ys, ylen, errs, audio, alen


def phase_legacy(torch):
    """The legacy v1 family (models/legacy.py) at width 600 on the card
    against the CPU port on the same weights and inputs: the MFCC_
    featurizer with CMVN (per utterance, 1e-4 of its largest magnitude),
    stacked 3 into input 120; the legacy transducer (encoder 4 x 600 with
    its 600 head, prediction net 1 x 600, vocab_embed_size 16, V=73 from
    LegacyCharTokenizer.legacy_vocab_size) at batch LEGACY_BATCH of 8-16 s:
    loss + gradients (K1/K4, the lattice's K9/K10; 1e-5 rel, each grad
    1e-3 of its max) and the greedy decode (tokens exact; K1 at T=1 a
    frame); RNNModel (4 x 600, V=73) with the CTC prefix beam search
    (width PREFIX_BEAM) of two utterances: labels exact, -logp 1e-6 rel;
    the spline time warp (features.time_warp method='spline', W=80) of the
    CTC phase's (32, T, 80) log-mels on the card == its resample on the
    same draws, and within the flow's fp32 error of the CPU's resample.
    Each run's launches counted and its kernel shapes recorded."""
    from edgedict_tpu_torch import features as F
    from edgedict_tpu_torch.models import legacy as L
    from edgedict_tpu_torch.ops import image_warp as W
    from edgedict_tpu_torch.tokenizer import LegacyCharTokenizer
    dev = torch.device('cuda')
    tok = LegacyCharTokenizer()
    xs, xlen, ys, ylen, mfcc_errs, _, alen = _legacy_batch(torch, dev, tok)
    cfg = L.LegacyTransducerConfig(
        input_size=xs.shape[2], vocab_size=tok.legacy_vocab_size(),
        vocab_embed_size=16, hidden_size=600, num_layers=4)
    model = L.LegacyTransducer(cfg, dev, seed=0)
    cpu = L.LegacyTransducer(cfg, 'cpu', seed=0)
    expect = STATE.setdefault('run_expect', {})
    on = [a.to(dev) for a in (ys, xlen, ylen)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _legacy_shapes('legacy_loss'):
        t0 = time.perf_counter()
        l_gpu, g_gpu = _loss_and_grads(torch, model, L.legacy_transducer_loss,
                                       xs, *on)
        torch.cuda.synchronize()
        loss_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    STATE['launches_legacy_loss'] = _launches()
    layers = cfg.num_layers + cfg.pred_num_layers
    expect['legacy_loss'] = _expect(lstm_fwd=layers, lstm_bwd=layers,
                                    lattice_alpha=1, lattice_beta_grad=1)
    l_cpu, g_cpu = _loss_and_grads(torch, cpu, L.legacy_transducer_loss,
                                   xs.cpu(), ys, xlen.cpu(), ylen)
    grad_rel = _grad_rel(torch, g_gpu, g_cpu)

    _reset_launches()
    with torch.no_grad(), _legacy_shapes('legacy_decode'):
        t0 = time.perf_counter()
        y_gpu, neg_gpu = L.legacy_greedy_decode(model, xs, xlen)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
    STATE['launches_legacy_decode'] = _launches()
    expect['legacy_decode'] = _expect(
        lstm_fwd=cfg.num_layers + cfg.pred_num_layers * (1 + xs.shape[1]))
    with torch.no_grad():
        y_cpu, neg_cpu = L.legacy_greedy_decode(cpu, xs.cpu(), xlen.cpu())
    tokens_equal = torch.equal(y_gpu.cpu(), y_cpu)

    rnn = L.RNNModel(xs.shape[2], cfg.vocab_size, 600, 4, dev, seed=1)
    rnn_cpu = L.RNNModel(xs.shape[2], cfg.vocab_size, 600, 4, 'cpu', seed=1)
    _reset_launches()
    with torch.no_grad(), _legacy_shapes('legacy_rnn'):
        logits, _ = L.rnn_model_apply(rnn, xs)
        torch.cuda.synchronize()
    STATE['launches_legacy_rnn'] = _launches()
    expect['legacy_rnn'] = _expect(lstm_fwd=4)
    with torch.no_grad():
        logits_cpu, _ = L.rnn_model_apply(rnn_cpu, xs.cpu())
    beams = []
    for i in range(2):
        n = int(xlen[i])
        got = L.ctc_prefix_beam_search(
            torch.log_softmax(logits[i, :n], -1), PREFIX_BEAM)
        want = L.ctc_prefix_beam_search(
            torch.log_softmax(logits_cpu[i, :n], -1), PREFIX_BEAM)
        beams.append({'labels_equal': got[0] == want[0],
                      'labels': len(got[0]),
                      'neg_logp_rel': abs(got[1] - want[1]) / abs(want[1])})

    feat = STATE['ctc_feats'][..., :80].contiguous()
    b, t, _ = feat.shape
    g = torch.Generator(device=dev).manual_seed(172)
    t0 = time.perf_counter()
    warped = F.time_warp(feat, SPLINE_W, g, method='spline')
    torch.cuda.synchronize()
    warp_first_ms = (time.perf_counter() - t0) * 1e3
    warp_ms = _median_ms(torch, lambda: F.time_warp(feat, SPLINE_W, g,
                                                    method='spline'),
                         iters=5, warmup=1)
    g = torch.Generator(device=dev).manual_seed(172)
    center = torch.randint(SPLINE_W, t - SPLINE_W, (b,), generator=g,
                           device=dev)
    shift = torch.randint(-SPLINE_W, SPLINE_W + 1, (b,), generator=g,
                          device=dev)
    again = W.time_warp_spline_resample(feat, center, shift)
    ref = W.time_warp_spline_resample(feat.cpu(), center.cpu(), shift.cpu())
    step = max(float(feat.diff(dim=1).abs().max()),
               float(feat.diff(dim=2).abs().max()))
    warp_tol = (1e-4 * (SPLINE_W + 1) + 1e-5) * step + 1e-5
    warp_err = float((warped.cpu() - ref).abs().max())
    res = {'phase': 'legacy', 'B': LEGACY_BATCH, 'T': xs.shape[1],
           'input': xs.shape[2], 'U_max': int(ylen.max()),
           'V': cfg.vocab_size, 'audio_s': float(alen.sum()) / 16000,
           'mfcc_max_rel': max(mfcc_errs),
           'loss_cuda': l_gpu, 'loss_cpu': l_cpu,
           'loss_rel': abs(l_gpu - l_cpu) / abs(l_cpu),
           'grad_max_rel': grad_rel, 'loss_step_ms': loss_ms,
           'peak_gb': peak, 'decode_ms': decode_ms,
           'tokens_equal': tokens_equal,
           'emitted_share': float((y_gpu != 0).float().mean()),
           'neg_logp_rel': float((neg_gpu.cpu() - neg_cpu).abs().max()
                                 / neg_cpu.abs().max()),
           'rnn_model_logits_max_abs': float((logits.cpu()
                                              - logits_cpu).abs().max()),
           'prefix_beam': beams, 'spline_B_T_F': [b, t, 80],
           'spline_first_call_ms': warp_first_ms, 'spline_ms': warp_ms,
           'spline_max_abs': warp_err,
           'spline_tol': warp_tol,
           'spline_equals_resample': torch.equal(warped, again),
           'bounds': 'mfcc 1e-4 of max, loss 1e-5 rel, each grad 1e-3 of '
                     'its max, tokens and prefix-beam labels exact, '
                     'neg_logp 1e-4 rel (beam 1e-6), spline (1e-4 (W+1) '
                     '+ 1e-5) x the largest neighbour step'}
    emit(res)
    require(max(mfcc_errs) <= 1e-4, 'legacy_mfcc on cuda differs')
    require(res['loss_rel'] <= 1e-5 and grad_rel <= 1e-3,
            'the legacy transducer loss or its gradients on cuda differ')
    require(tokens_equal and res['neg_logp_rel'] <= 1e-4,
            'the legacy greedy decode on cuda differs from the CPU')
    require(res['rnn_model_logits_max_abs'] <= 1e-4
            and all(x['labels_equal'] and x['neg_logp_rel'] <= 1e-6
                    for x in beams), f'prefix beam search differs: {beams}')
    require(res['spline_equals_resample'] and warp_err <= warp_tol
            and float((warped - feat).abs().max()) > 1e-2,
            'the spline time warp on cuda differs from the CPU')


def phase_legacy_kernels(torch):
    """Each kernel that the ctc and legacy phases launched (K1, K4, and the
    lattice's K9 / K10) against its plain version at the shapes those runs
    gave it (STATE['legacy_shapes']; H=600, each shape once): K1 fp32
    (lstm_fwd_case) and bf16 held step by step (bf16_forward_case), K4
    (lstm_bwd_case); K9 / K10 on seeded log-probs at the run's own
    lengths (lattice_long_cases).  First each run's recorded calls are held
    against its launch counts: the spies saw every launch.  Beside each
    K1 / K4 shape, one cuDNN layer (layer_times, forward or forward +
    backward) at each input width that the runs' layers of that shape had
    (the CTC's 240 and 600, the legacy encoders' 120 and 600, the
    prediction net's 16)."""
    record, dev = STATE['record'], torch.device('cuda')
    rng = np.random.RandomState(16)
    logs_of = STATE['legacy_shapes']
    readable = {run: {name: [[str(x) for x in key] for key in log['keys']]
                      for name, log in logs.items() if log['calls']}
                for run, logs in logs_of.items()}
    emit({'phase': 'legacy_kernels', 'shapes': readable})
    fwd, bwd, lattice, widths = {}, {}, {}, {}
    for run, logs in logs_of.items():
        n = STATE['launches_' + run]
        calls = {name: logs[name]['calls'] for name in ('lstm_fwd',
                                                        'lstm_bwd',
                                                        'lattice')}
        want = {'lstm_fwd': n['lstm_fwd'], 'lstm_bwd': n['lstm_bwd'],
                'lattice': n['lattice_alpha']}
        require(calls == want and n['lattice_beta_grad'] <= calls['lattice'],
                f'{run}: recorded calls {calls}, launches {n}')
        require(all(not logs[name]['calls'] for name in logs
                    if name not in calls and name != 'lstm_layer'),
                f'{run} called a kernel outside K1, K4, K9, K10')
        for hid, b, t, n_in in logs['lstm_layer']['keys']:
            widths.setdefault((hid, b, t), set()).add(n_in)
        fwd.update(logs['lstm_fwd']['keys'])
        bwd.update(logs['lstm_bwd']['keys'])
        for key, lens in logs['lattice']['keys'].items():
            lattice.setdefault(key, (lens, n['lattice_beta_grad'] > 0))
    require(all(key[:3] in widths for key in (*fwd, *bwd)),
            f'a K1 / K4 shape without its layer: {sorted(widths)}')
    for hid, b, t, dt in fwd:
        if dt == torch.bfloat16:
            bf16_forward_case(torch, rng, dev, record, 'LSTM', b, t, None,
                              hid=hid)
        else:
            lstm_fwd_case(torch, rng, dev, record, hid, b, t, dt)
    for hid, b, t, dt in bwd:
        lstm_bwd_case(torch, rng, dev, record, hid, b, t, dt)
    for backward, keys in ((False, fwd), (True, bwd)):
        for hid, b, t, dt in keys:
            for n_in in sorted(widths[hid, b, t]):
                emit({'phase': 'legacy_layer', 'H': hid, 'B': b, 'T': t,
                      'dtype': str(dt).split('.')[-1], 'n_in': n_in,
                      'backward': backward,
                      **layer_times(torch, 'LSTM', hid, b, t, dt, backward,
                                    n_in)})
    for (b, t, u1), ((xlen, ylen), backward) in lattice.items():
        lattice_long_cases(torch, rng, dev, record, b, t, u1, xlen, ylen,
                           backward=backward)



# ---------------------------------------------------------------------------
# the JAX-free surface, data parallelism and sharded serving
# ---------------------------------------------------------------------------

SURFACE_BATCH = 4
SURFACE_SECONDS = 16.0
# cuFFT against the CPU's pocketfft, both fp32, on log features: the
# filterbank's (64 mel sums) within 1e-3, the log magnitude spectrogram's
# within 2e-2 (its bins near the noise floor carry the fp32 STFT's
# rounding into the log: 2.1e-3 against fp64 on the CPU); build_transform's
# log-mel at JAX's own Pallas-vs-XLA bound (tests/test_features.py:213)
SURFACE_ATOL = {'NvidiaFilterbankFeatures': 1e-3, 'SpectrogramFeatures': 2e-2}
LOG_MEL_RTOL, LOG_MEL_ATOL = 1e-3, 5e-3


def phase_surface(torch):
    """The JAX-free featurizers of Queue 1 item 13b on the card:
    NvidiaFilterbankFeatures and SpectrogramFeatures (plain torch.fft) on
    cuda against the CPU at B=4 x 16 s, 64 filters, fp32 (TF32 off); and
    build_transform's test pipeline at E6D2's features on cuda (K2, one
    launch, counted) against its plain version on the CPU."""
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    from edgedict_tpu_torch.data import nvidia_features as NV
    from edgedict_tpu_torch.features import build_transform
    n = int(SURFACE_SECONDS * 16000)
    audio = torch.as_tensor(np.stack([synthetic_audio(200 + i,
                                                      SURFACE_SECONDS)
                                      for i in range(SURFACE_BATCH)]))
    lens = torch.tensor([n, n - 16000, n - 56000, n - 96000])
    res = {'phase': 'surface', 'B': SURFACE_BATCH,
           'seconds': SURFACE_SECONDS}
    cfg = NV.NvidiaFeatConfig(sample_rate=16000, window_size=0.02,
                              window_stride=0.01, nfilt=64, dither=0.0,
                              pad_to=8)
    audio_dev, lens_dev = audio.cuda(), lens.cuda()
    for name in SURFACE_ATOL:
        feat = getattr(NV, name)(cfg)
        want = feat(audio, lens)
        dev = feat.to('cuda')
        got = dev(audio_dev, lens_dev)
        ms = _median_ms(torch, lambda: dev(audio_dev, lens_dev))
        err = float((got.cpu() - want).abs().max())
        res[name] = {'shape': list(got.shape), 'max_abs_err': err,
                     'atol': SURFACE_ATOL[name], 'ms': ms,
                     'finite': bool(torch.isfinite(got).all())}
        require(got.shape == want.shape and res[name]['finite']
                and err <= SURFACE_ATOL[name],
                f'{name} on cuda differs from the CPU: {res[name]}')
    _, e6d2 = _e6d2_train_cfg()
    kw = dict(feature_type=e6d2.feature_type,
              feature_size=e6d2.feature_size, n_fft=e6d2.n_fft,
              win_length=e6d2.win_length, hop_length=e6d2.hop_length,
              downsample=e6d2.downsample)
    _, test_cpu, size = build_transform(device='cpu', **kw)
    _, test_cuda, _ = build_transform(device='cuda', **kw)
    want, want_len = test_cpu(audio, lens)
    _reset_launches()
    got, got_len = test_cuda(audio_dev, lens_dev)
    torch.cuda.synchronize()
    STATE['launches_surface'] = _launches()
    STATE.setdefault('run_expect', {})['surface'] = _expect(mel_power=1)
    close = torch.isclose(got.cpu(), want, rtol=LOG_MEL_RTOL,
                          atol=LOG_MEL_ATOL)
    res['build_transform'] = {
        'features': 'E6D2 logfbank 80 x 3 stacked', 'input_size': size,
        'shape': list(got.shape),
        'max_abs_err': float((got.cpu() - want).abs().max()),
        'rtol': LOG_MEL_RTOL, 'atol': LOG_MEL_ATOL,
        'lengths_equal': bool(torch.equal(got_len.cpu(), want_len))}
    emit(res)
    require(bool(close.all()) and res['build_transform']['lengths_equal']
            and got.shape[-1] == size,
            f'build_transform on cuda differs from plain: '
            f'{res["build_transform"]}')


DP_RANKS = 2
DP_ROWS = 8               # rows a rank
DP_STEPS = 3
DP_LRS = (5e-4, 4e-4, 3e-4)
# the two ranks' parameters after the steps against the one-process run
DP_RTOL, DP_ATOL = 1e-4, 1e-5


def _dp_host_batches():
    """DP_STEPS host batches of DP_RANKS x DP_ROWS rows of seeded synthetic
    audio (1.5-2.5 s, padded to one length) and labels."""
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    rng = np.random.RandomState(17)
    rows = DP_RANKS * DP_ROWS
    secs = rng.uniform(1.5, 2.5, (DP_STEPS, rows))
    audio = np.zeros((DP_STEPS, rows, int(2.5 * 16000)), np.float32)
    for s in range(DP_STEPS):
        for r in range(rows):
            a = synthetic_audio(300 + s * rows + r, secs[s, r])
            audio[s, r, :len(a)] = a
    return {'audio': audio,
            'alen': (secs * 16000).astype(np.int32),
            'ys': rng.randint(4, 2048, (DP_STEPS, rows, 16)).astype(
                np.int32),
            'ylen': rng.randint(8, 17, (DP_STEPS, rows)).astype(np.int32)}


def _dp_steps(torch, model_seed, batches, rows, accum):
    """The shared fp32 train step (E6D2, the trainer's features without
    dither or SpecAugment) on cuda over `rows` of each host batch in
    `accum` micro-batches, from make_train_state(seed) (broadcast from rank
    0 under a process group) → (losses, grad norms, skips, step s, launch
    counts of the steps, params)."""
    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.features import FeaturePipeline
    cfg, feat = _e6d2_train_cfg()
    opt = optim.build_optimizer('adam')
    state = TR.make_train_state(cfg, opt, 'cuda', seed=model_seed)
    TR.broadcast_module(state.model)
    state.opt_state = opt.init(dict(state.model.named_parameters()))
    pipe = FeaturePipeline(feat, 'cuda')
    step = TR.make_train_step(cfg, opt, bf16=False, feature_pipeline=pipe)
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = {'losses': [], 'grad_norms': [], 'skipped': [], 'step_s': []}
    _reset_launches()
    for s, lr in enumerate(DP_LRS):
        dev = TR.device_batch({k: v[s, rows] for k, v in batches.items()},
                              accum, 'cuda')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, dev, lr, gen)
        out['losses'].append(float(m['loss']))
        out['step_s'].append(time.perf_counter() - t0)
        out['grad_norms'].append(float(m['grad_norm']))
        out['skipped'].append(float(m['skipped']))
    out['launches'] = _launches()
    out['params'] = {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}
    return out


def dp_rank(rank, rendezvous, batches_path, out_path):
    """One rank of phase dp_train (a), spawned by it: a gloo process group
    on cuda:0 (file:// rendezvous), first a probe that gloo all-reduces a
    CUDA tensor, then _dp_steps on this rank's rows; torch.save's its
    results to out_path."""
    import torch
    import torch.distributed as dist
    set_numerics(torch)
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'file://{rendezvous}',
                            rank=rank, world_size=DP_RANKS)
    try:
        probe = torch.ones(4, device='cuda')
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:
            torch.save({'gloo_cuda': False, 'error': str(e)}, out_path)
            return
        with np.load(batches_path) as f:
            batches = {k: f[k] for k in f.files}
        rows = slice(rank * DP_ROWS, (rank + 1) * DP_ROWS)
        out = _dp_steps(torch, rank, batches, rows, 1)
        out['gloo_cuda'] = bool((probe == DP_RANKS).all())
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(torch, tmp, batches):
    """Two dp_rank processes on cuda:0; → their results."""
    path = os.path.join(tmp, 'batches.npz')
    np.savez(path, **batches)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = []
    for r in range(DP_RANKS):
        code = (f'import chip_smoke; chip_smoke.dp_rank({r}, '
                f'{os.path.join(tmp, "rendezvous")!r}, {path!r}, '
                f'{os.path.join(tmp, f"rank{r}.pt")!r})')
        procs.append(subprocess.Popen([sys.executable, '-c', code],
                                      cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        require(p.returncode == 0, f'a dp rank failed:\n{log[-3000:]}')
    return [torch.load(os.path.join(tmp, f'rank{r}.pt'))
            for r in range(DP_RANKS)]


def _dp_cli(torch):
    """(b): python -m torch.distributed.run --standalone --nproc_per_node 1
    -m edgedict_tpu_torch.cli.distributed on train_run's corpus (E6D2,
    batch 32, bf16: one epoch of 3 steps, an eval at step 3, NCCL); rank
    0's checkpoint loads into the E6D2 model."""
    from edgedict_tpu_torch import config as C
    from edgedict_tpu_torch.checkpoint import checkpoint_path, load_checkpoint
    from edgedict_tpu_torch.cli import distributed
    from edgedict_tpu_torch.compat import transducer_from_state_dict
    tmp, base = _train_corpus()
    argv = base + ['--name', 'dp-cli', '--epochs', '1', '--loss_step', '1',
                   '--save_step', '3', '--eval_step', '3', '--dp_size', '1']
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-m', 'torch.distributed.run',
                        '--standalone', '--nproc_per_node', '1', '-m',
                        'edgedict_tpu_torch.cli.distributed', *argv],
                       cwd=tmp, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    require(r.returncode == 0, f'cli.distributed under torchrun failed:\n'
            f'{r.stdout[-2000:]}\n{r.stderr[-3000:]}')
    flags = C.parse_flags(distributed.build_parser(), argv)
    path = checkpoint_path(os.path.join(flags.logdir_root, flags.name), 3)
    cfg, _ = _e6d2_train_cfg()
    model = transducer_from_state_dict(load_checkpoint(path)['model'], cfg,
                                       'cpu')
    evals = [ln for ln in lines if ln.startswith('eval @ 3:')]
    res = {'command': 'python -m torch.distributed.run --standalone '
                      '--nproc_per_node 1 -m '
                      'edgedict_tpu_torch.cli.distributed',
           'wall_s': wall, 'process': [ln for ln in lines
                                       if ln.startswith('process ')],
           'steps': [ln for ln in lines if ln.startswith('step ')],
           'eval': evals, 'checkpoint': os.path.basename(path),
           'params': sum(p.numel() for p in model.parameters())}
    require(res['process'] == ['process 0/1 on cuda:0 (nccl)']
            and len(res['steps']) == 3 and len(evals) == 1
            and np.isfinite(float(evals[0].split()[4])),
            f'cli.distributed did not train and evaluate: {res}')
    return res


def phase_dp_train(torch):
    """Data-parallel training on the one card.  (a) two ranks spawned on
    cuda:0 over gloo (NCCL refuses two ranks on one device) run the shared
    fp32 step on the full-width E6D2 model with 8 rows each for 3 Adam
    steps (rank 1 starts from its own seed and takes rank 0's parameters
    by broadcast); their parameters and losses must equal a one-process
    run over the same 16 rows in rank order with accum_steps=2 (rtol 1e-4
    / atol 1e-5).  Each rank's launch counts join the kernels line.  (b)
    cli.distributed under torchrun with NCCL (_dp_cli).  Two ranks on one
    card share it: their step times measure no scaling."""
    import tempfile
    batches = _dp_host_batches()
    tmp = tempfile.mkdtemp(prefix='edd_dp_')
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, tmp, batches)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {'phase': 'dp_train', 'config': 'flagfiles/E6D2.txt fp32',
           'ranks': DP_RANKS, 'rows_a_rank': DP_ROWS, 'steps': DP_STEPS,
           'gloo_cuda': [r['gloo_cuda'] for r in ranks]}
    if all(r['gloo_cuda'] for r in ranks):
        one = _dp_steps(torch, 0, batches, slice(None), 2)
        diffs = {}
        for r, out in enumerate(ranks):
            diffs[r] = max(float(((p - one['params'][k]).abs()
                                  - DP_RTOL * one['params'][k].abs()).max())
                           for k, p in out['params'].items())
        ranks_equal = all(torch.equal(p, ranks[0]['params'][k])
                          for k, p in ranks[1]['params'].items())
        res.update({
            'spawn_wall_s': spawn_s,
            'losses': [r['losses'] for r in ranks],
            'losses_one_process': one['losses'],
            'grad_norms': [r['grad_norms'] for r in ranks],
            'grad_norms_one_process': one['grad_norms'],
            'skipped': [r['skipped'] for r in ranks],
            'step_ms': [[1e3 * s for s in r['step_s']] for r in ranks],
            'step_ms_one_process': [1e3 * s for s in one['step_s']],
            'param_excess_over_rtol': diffs, 'ranks_bit_equal': ranks_equal,
            'bounds': f'params rtol {DP_RTOL} atol {DP_ATOL}, losses rtol '
                      f'{DP_RTOL}'})
        for r, out in enumerate(ranks):
            STATE['launches_dp_rank%d' % r] = out['launches']
            STATE.setdefault('run_expect', {})['dp_rank%d' % r] = \
                _train_expect(_e6d2_train_cfg()[0], DP_STEPS)
        require(all(not any(r['skipped']) for r in ranks),
                f'a dp step was skipped: {res["skipped"]}')
        require(ranks_equal, 'the two ranks hold different parameters')
        require(all(d <= DP_ATOL for d in diffs.values()),
                f'dp params differ from the one-process run: {diffs}')
        require(all(np.allclose(r['losses'], one['losses'], rtol=DP_RTOL,
                                atol=0) for r in ranks),
                'dp losses differ from the one-process run')
    else:
        res['gloo_cuda_error'] = [r.get('error') for r in ranks]
    res['cli'] = _dp_cli(torch)
    emit(res)


SERVER_DP_STREAMS = 8
SERVER_DP_DEVICES = ('cuda:0', 'cuda:0')


def _dp_rounds(dec, frames, count):
    """Every round of `frames` through dec (greedy: tokens a round; beam:
    the best hypotheses after the last) → (outputs, round ms); with
    `count`, the rounds' launches to STATE['launches_' + count]."""
    import torch
    dec.reset()
    if count:
        _reset_launches()
    times, out = [], []
    for f in frames:
        t0 = time.perf_counter()
        if hasattr(dec, 'replicas'):
            out.append(dec._tokens(dec._launch(f)))
        else:
            dec.decode(f)
        times.append(1e3 * (time.perf_counter() - t0))
    if not hasattr(dec, 'replicas'):
        from edgedict_tpu_torch.models.beam_search import best_hypothesis
        for beam in dec.beams:
            toks, n_tok, logp = best_hypothesis(beam)
            out.append((toks.cpu().numpy(), n_tok.cpu().numpy(),
                        logp.cpu().numpy()))
        out = [np.concatenate([o[i] for o in out]) for i in range(3)]
    torch.cuda.synchronize()
    if count:
        STATE['launches_' + count] = _launches()
    return out, times


def phase_server_dp(torch):
    """Sharded serving on the card: MultiStreamDecoder and
    MultiStreamBeamDecoder (W=4, no LM), both on the beam phases' peaky
    weights, at E6D2 in fp32 and int8, 8 streams over devices=[cuda:0,
    cuda:0] (two replicas of 4 streams; one card cannot show a second
    device) against
    the one-device decoder over the same rounds: tokens bit-equal (beam:
    the best hypotheses' tokens and lengths; their log-probs beside).  The
    sharded rounds' launches are counted exactly.  cli.serve
    --serve_dp_size 2 is refused on a one-card machine."""
    from edgedict_tpu_torch import config as C
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli import serve
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    cfg, feat = _e6d2()
    tok = StandInTokenizer(cfg.vocab_size)
    model, _ = _beam_models(torch)
    audios = [synthetic_audio(40 + i, seconds=3.0)
              for i in range(SERVER_DP_STREAMS)]
    res = {'phase': 'server_dp', 'n_streams': SERVER_DP_STREAMS,
           'devices': list(SERVER_DP_DEVICES)}
    replicas = len(SERVER_DP_DEVICES)
    for beam in (False, True):
        for quantize in (None, 'int8'):
            cls = S.MultiStreamBeamDecoder if beam else S.MultiStreamDecoder
            kw = dict(quantize=quantize, **(BEAM if beam else {}))
            one = cls(model, cfg, feat, tok, SERVER_DP_STREAMS,
                      device='cuda', **kw)
            two = cls(model, cfg, feat, tok, SERVER_DP_STREAMS,
                      devices=list(SERVER_DP_DEVICES), **kw)
            chunks = [S._chunks(a, one.win_size, one.hop_size)
                      for a in audios]
            frames = np.stack(chunks, 1)
            run = 'server_dp' + ('_beam' if beam else '') + (
                '_int8' if quantize else '')
            _dp_rounds(two, frames[:1], None)              # warm-up
            got, two_ms = _dp_rounds(two, frames, run)
            want, one_ms = _dp_rounds(one, frames, None)
            if beam:
                equal = all(np.array_equal(g, w) for g, w in
                            zip(got[:2], want[:2]))
                extra = {'logp_max_abs_diff': float(np.abs(
                    got[2] - want[2]).max()),
                    'tokens': [int(n) for n in got[1]]}
            else:
                equal = all(np.array_equal(g, w) for g, w in zip(got, want))
                extra = {'emitted': int(sum((g > 3).sum() for g in got))}
            n = len(frames)
            per = {'mel_power': n * replicas}
            if quantize:
                per.update(quant_matmul=7 * n * replicas,
                           lstm_fwd_q=6 * n * replicas)
            else:
                per['lstm_fwd'] = 6 * n * replicas
            if beam:
                frames_per_chunk = -(-two.rt.pipeline.num_frames(
                    two.win_size) // cfg.time_scale)
                per['lstm_fwd'] = per.get('lstm_fwd', 0) + (
                    frames_per_chunk * n * BEAM['max_sym_per_frame']
                    * cfg.dec_layers * replicas)
            else:
                per['greedy_decode'] = n * replicas
            STATE.setdefault('run_expect', {})[run] = _expect(**per)
            res[run] = {'rounds': n, 'tokens_equal': equal,
                        'round_ms_sharded': statistics.median(two_ms),
                        'round_ms_one_device': statistics.median(one_ms),
                        **extra}
            require(equal, f'{run}: the sharded decoder\'s tokens differ '
                           'from the one-device decoder\'s')
            del one, two
    # one visible card: --serve_dp_size 2 stops the parse (exit 2)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            C.parse_flags(serve.build_parser(), [
                f'--flagfile={REPO}/flagfiles/E6D2.txt', '--serve_dp_size',
                '2'])
        refused = None
    except SystemExit as e:
        refused = e.code
    res['cli_serve_dp_size_2_exit'] = refused
    res['cli_serve_dp_size_2_error'] = err.getvalue().splitlines()[-1:]
    emit(res)
    require(refused == 2 or torch.cuda.device_count() >= 2,
            'cli.serve took --serve_dp_size 2 on a one-card machine')
    require(all(res[r]['emitted'] > 0 for r in ('server_dp',
                                                 'server_dp_int8')),
            'the sharded greedy decoder emitted nothing')



# tensor and pipeline parallelism (Queue 1 item 14b) on the one card: every
# slot of the grid on cuda:0, so these phases measure no scaling
PAR_ROWS = 32             # E6D2's batch, as accum 2 x its sub-batch 16
PAR_ACCUM = 2
PAR_LR = 5e-4
PAR_BF16_STEPS = 3
TP_LATTICE = (32, 214, 65)    # (B, T, U+1) of the K7 / K8 slice cases


def _par_host_batch():
    """PAR_ROWS rows of seeded synthetic audio (2-4 s, padded to one
    length) and labels of 8-16 tokens."""
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    rng = np.random.RandomState(23)
    secs = rng.uniform(2.0, 4.0, PAR_ROWS)
    audio = np.zeros((PAR_ROWS, 4 * 16000), np.float32)
    for r, sec in enumerate(secs):
        a = synthetic_audio(500 + r, sec)
        audio[r, :len(a)] = a
    return {'audio': audio, 'alen': (secs * 16000).astype(np.int32),
            'ys': rng.randint(4, 2048, (PAR_ROWS, 16)).astype(np.int32),
            'ylen': rng.randint(8, 17, PAR_ROWS).astype(np.int32)}


def _par_steps(torch, host, layout, accum, bf16, steps, lr, run=None):
    """`steps` Adam steps of the E6D2 train step (the trainer's features
    without dither or SpecAugment) from make_train_state(seed 0) placed by
    `layout` (None: one device) on one device batch of `accum`
    micro-batches: make_train_step_pp where layout.pp > 1, else
    make_train_step, after one warm-up step on a copy of the state.  With
    `run`, the steps' launches go to STATE['launches_' + run].  → losses,
    grad norms, skips, step ms (each synchronised), peak GB and the params
    after."""
    import copy

    from edgedict_tpu_torch import parallel
    from edgedict_tpu_torch import train as TR
    from edgedict_tpu_torch.features import FeaturePipeline
    from edgedict_tpu_torch.models.transducer import build_optimizer
    from edgedict_tpu_torch.parallel.pipeline import make_train_step_pp
    cfg, feat = _e6d2_train_cfg()
    opt = build_optimizer(cfg, 'adam', shards=parallel.vocab_shards(
        cfg, layout) if layout else None)
    state = TR.make_train_state(cfg, opt, 'cuda', seed=0, layout=layout)
    pipe = FeaturePipeline(feat, 'cuda')
    step = make_train_step_pp(cfg, opt, layout, bf16=bf16,
                              feature_pipeline=pipe) \
        if layout is not None and layout.pp > 1 else \
        TR.make_train_step(cfg, opt, bf16=bf16, feature_pipeline=pipe)
    batch = TR.device_batch(host, accum, 'cuda')
    step(copy.deepcopy(state), batch, lr,          # warm-up, on a copy
         torch.Generator(device='cuda').manual_seed(0))
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = {'losses': [], 'grad_norms': [], 'skipped': [], 'step_ms': []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if run:
        _reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, lr, gen)
        out['losses'].append(float(m['loss']))
        out['step_ms'].append(1e3 * (time.perf_counter() - t0))
        out['grad_norms'].append(float(m['grad_norm']))
        out['skipped'].append(float(m['skipped']))
    if run:
        STATE['launches_' + run] = _launches()
        STATE.setdefault('run_expect', {})[run] = _par_expect(
            cfg, steps * accum, layout.tp if layout else 1)
    out['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
    out['params'] = {k: v.detach().cpu() for k, v in
                     state.model.state_dict().items()}
    return out


def _par_expect(cfg, micro_steps, slices):
    """Launches of micro_steps feature-Trainer micro-steps (LSTM) whose
    joint runs in `slices` vocabulary slices (K7 and K8 once a slice)."""
    want = _train_expect(cfg, micro_steps)
    want['joint_lse_fwd'] = want['joint_lse_bwd'] = micro_steps * slices
    return want


def _par_compare(got, want):
    """Params and losses after the steps against the reference run's:
    {the largest excess of |got - want| over PAR_RTOL·|want| (dp_train's
    measure), the largest |got - want|, the share of params off by more
    than 0.01 lr (train_parity's measures: Adam's first step is g / |g|,
    so a gradient at its rounding level may flip sign), the losses' and
    the first grad norms' largest relative difference}."""
    diffs = {k: (p - want['params'][k]).abs()
             for k, p in got['params'].items()}
    n = sum(d.numel() for d in diffs.values())
    return {
        'param_excess_over_rtol': max(
            float((d - DP_RTOL * want['params'][k].abs()).max())
            for k, d in diffs.items()),
        'param_max_abs_diff': max(float(d.max()) for d in diffs.values()),
        'param_share_diff_over_0.01lr': sum(
            int((d > 0.01 * PAR_LR).sum()) for d in diffs.values()) / n,
        'loss_rel': max(abs(a - b) / abs(b) for a, b in
                        zip(got['losses'], want['losses'])),
        'grad_norm_rel': abs(got['grad_norms'][0] - want['grad_norms'][0])
        / want['grad_norms'][0]}


def _par_plain(torch, host):
    """The one-device fp32 step with accum_steps = PAR_ACCUM that pp_train
    and tp_train are held against (computed once)."""
    if 'par_plain' not in STATE:
        STATE['par_plain'] = _par_steps(torch, host, None, PAR_ACCUM, False,
                                        1, PAR_LR)
    return STATE['par_plain']


def phase_pp_train(torch):
    """Pipeline parallelism at E6D2 full width (flagfiles/E6D2.txt: 6 x 1024,
    a tail of 4 after the reduction at layer 1) on make_layout(pp=2,
    devices=[cuda:0] * 2), batch 32 as accum 2 x 16: one fp32 Adam step
    of make_train_step_pp equals the plain step with accum_steps = 2
    (loss rel 1e-5, params rtol 1e-4 / atol 1e-5, dp_train's bounds), its
    launches those of 2 plain micro-steps; then 3 bf16 Adam steps at pp = 4
    (accum 4, pick_accum_steps' pp rule) lower the loss on the repeated
    batch.  Step ms and peak memory of each."""
    from edgedict_tpu_torch import parallel
    from edgedict_tpu_torch.trainer import pick_accum_steps
    host = _par_host_batch()
    plain = _par_plain(torch, host)
    pp2 = _par_steps(torch, host, parallel.make_layout(
        pp=2, devices=['cuda:0'] * 2), PAR_ACCUM, False, 1, PAR_LR,
        run='pp_train')
    cmp = _par_compare(pp2, plain)
    accum4 = pick_accum_steps(PAR_ROWS, 16, pp=4)
    pp4 = _par_steps(torch, host, parallel.make_layout(
        pp=4, devices=['cuda:0'] * 4), accum4, True, PAR_BF16_STEPS, 1e-3,
        run='pp_train_bf16')
    res = {'phase': 'pp_train', 'config': 'flagfiles/E6D2.txt',
           'rows': PAR_ROWS, 'devices': 'cuda:0 x pp',
           'pp2_fp32': {'accum': PAR_ACCUM, 'loss': pp2['losses'][0],
                        'loss_plain': plain['losses'][0],
                        'grad_norm': pp2['grad_norms'][0],
                        'grad_norm_plain': plain['grad_norms'][0], **cmp,
                        'step_ms': pp2['step_ms'][0],
                        'step_ms_plain': plain['step_ms'][0],
                        'peak_gb': pp2['peak_gb'],
                        'peak_gb_plain': plain['peak_gb']},
           'pp4_bf16': {'accum': accum4, 'losses': pp4['losses'],
                        'step_ms': pp4['step_ms'],
                        'peak_gb': pp4['peak_gb']},
           'bounds': f'loss rel {DP_RTOL / 10}, params rtol {DP_RTOL} atol '
                     f'{DP_ATOL}; bf16 losses falling',
           'note': 'every stage on cuda:0: no scaling is measured'}
    emit(res)
    require(not any(pp2['skipped'] + pp4['skipped']),
            'a pipelined step was skipped')
    require(cmp['loss_rel'] <= DP_RTOL / 10
            and cmp['param_excess_over_rtol'] <= DP_ATOL,
            f'the pp = 2 step differs from the plain step: {res["pp2_fp32"]}')
    require(accum4 == 4 and pp4['losses'][-1] < pp4['losses'][0],
            f'the bf16 pp = 4 steps did not lower the loss: {pp4["losses"]}')


def _finite_rel(torch, a, b):
    """_rel over the entries b holds finite, the -inf entries (an id the
    slice does not own) required -inf in a too; inf if they differ."""
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or \
            not bool((a[~fin] == b[~fin]).all()):
        return float('inf')
    return _rel(torch, torch.where(fin, a, 0.0), torch.where(fin, b, 0.0))


def _tp_slice_cases(torch, record):
    """K7 and K8 on each vocabulary slice of the E6D2 step (B=32, T=214,
    U+1=65, J=640, V/2=1024 + the sentinel column), bf16 and fp32, against
    the plain K7 / K8 of the slice (joint_lse_fwd_plain /
    joint_lse_bwd_plain), K8 given the whole vocabulary's lse from the
    slices' K7: log-probs to 1e-4 and gradients to 2e-2 of max(1,
    max|ref|), the -inf of foreign ids exact; slice 0 timed in bf16 with
    its bound.  → the cases."""
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.parallel import vocab as PV
    dev = torch.device('cuda')
    rng = np.random.RandomState(31)
    (b, t, u1), j, v, tp = TP_LATTICE, 640, 2048, 2

    def t_(*shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale).astype(np.float32),
                               device=dev)
    f, g = t_(b, t, j), t_(b, u1, j)
    w_t, bias = t_(j, v, scale=j ** -0.5), t_(v, scale=0.1)
    labels = torch.as_tensor(rng.randint(1, v, (b, u1 - 1)).astype(np.int32),
                             device=dev)
    d_b, d_l = t_(b, t, u1, scale=0.1), t_(b, t, u1 - 1, scale=0.1)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        probs = [PV.slice_problem(w.to(dt).contiguous(), bi, labels, 0,
                                  k * (v // tp))
                 for k, (w, bi) in enumerate(zip(w_t.chunk(tp, 1),
                                                 bias.chunk(tp)))]
        args = [(f.to(dt), g.to(dt), w_p.contiguous(), b_p.contiguous(),
                 lab.contiguous(), blank_k)
                for w_p, b_p, lab, blank_k in probs]
        fwd = [KJ.joint_lse_fwd(*a) for a in args]
        lse = torch.logsumexp(torch.stack([o[2] for o in fwd]), 0)
        for k, (a, out) in enumerate(zip(args, fwd)):
            ref = KJ.joint_lse_fwd_plain(*a)
            fwd_err = max(_finite_rel(torch, x, r) for x, r in zip(out, ref))
            del ref
            grads = KJ.joint_lse_bwd(*a, lse, d_b, d_l)
            ref_g = KJ.joint_lse_bwd_plain(*a, lse, d_b, d_l)
            bwd_err = max(_rel(torch, x, r) for x, r in zip(grads, ref_g))
            del ref_g
            torch.cuda.synchronize()
            case = {'kernel': 'K7/K8 joint_lse vocab slice', 'slice': k,
                    'B': b, 'T': t, 'U1': u1, 'J': j, 'V_slice': v // tp,
                    'V_padded_cols': a[2].shape[1],
                    'dtype': str(dt).split('.')[-1], 'fwd_rel': fwd_err,
                    'bwd_rel': bwd_err, 'blank_on_sentinel': a[5] != 0,
                    'tol': 'lp 1e-4, grads 2e-2, of max(1, max|ref|); '
                           '-inf exact'}
            if dt == torch.bfloat16 and k == 0:
                ops = 2 * b * t * u1 * j * a[2].shape[1]
                ms, pms = time_pair(torch, lambda: KJ.joint_lse_fwd_plain(*a),
                                    lambda: KJ.joint_lse_fwd(*a))
                bms, bpms = time_pair(
                    torch, lambda: KJ.joint_lse_bwd_plain(*a, lse, d_b, d_l),
                    lambda: KJ.joint_lse_bwd(*a, lse, d_b, d_l))
                fb = bound(nbytes(*a[:5], *out), ops, 'bf16')
                bb = bound(nbytes(*a[:5], lse, d_b, d_l, *grads), 3 * ops,
                           'bf16')
                case.update(fwd_ms=ms, fwd_plain_ms=pms, fwd_bound_ms=fb[0],
                            fwd_bound_by=fb[1], bwd_ms=bms, bwd_plain_ms=bpms,
                            bwd_bound_ms=bb[0], bwd_bound_by=bb[1])
            emit(case)
            cases.append(case)
            record('joint_lse_fwd', fwd_err)
            record('joint_lse_bwd', bwd_err)
            require(fwd_err <= 1e-4 and bwd_err <= 2e-2,
                    f'K7/K8 disagree on a vocabulary slice: {case}')
            del grads
        del fwd, lse
    return cases


def phase_tp_train(torch):
    """Tensor parallelism at E6D2 full width on make_layout(tp=2,
    devices=[cuda:0] * 2): K7 and K8 on each vocabulary slice against the
    slice's plain version (_tp_slice_cases), then one fp32 Adam step of
    the train step at tp = 2 (batch 32 as accum 2 x 16) equals the tp = 1
    step: loss and grad norm rel 1e-5, params within train_parity's
    bounds (the slices' log-probs are combined, so gradients differ at
    their rounding level and Adam's first step g / |g| may flip the sign
    of one at that level), its launches those of 2 micro-steps with K7
    and K8 twice each.  Step ms and peak memory."""
    from edgedict_tpu_torch import parallel
    record = STATE.get('record') or (lambda *a, **k: None)
    cases = _tp_slice_cases(torch, record)
    host = _par_host_batch()
    plain = _par_plain(torch, host)
    tp2 = _par_steps(torch, host, parallel.make_layout(
        tp=2, devices=['cuda:0'] * 2), PAR_ACCUM, False, 1, PAR_LR,
        run='tp_train')
    cmp = _par_compare(tp2, plain)
    res = {'phase': 'tp_train', 'config': 'flagfiles/E6D2.txt fp32',
           'rows': PAR_ROWS, 'accum': PAR_ACCUM, 'devices': 'cuda:0 x tp',
           'slice_cases': len(cases), 'loss': tp2['losses'][0],
           'loss_tp1': plain['losses'][0],
           'grad_norm': tp2['grad_norms'][0],
           'grad_norm_tp1': plain['grad_norms'][0], **cmp,
           'step_ms': tp2['step_ms'][0],
           'step_ms_tp1': plain['step_ms'][0], 'peak_gb': tp2['peak_gb'],
           'peak_gb_tp1': plain['peak_gb'],
           'bounds': 'loss and grad_norm rel 1e-5, params max 2 lr and '
                     '> 0.01 lr on < 1e-3 of them (train_parity\'s: the '
                     'log-probs are combined over the slices, so the '
                     'gradients differ at their rounding level)',
           'note': 'both slices on cuda:0: no scaling is measured'}
    emit(res)
    require(not any(tp2['skipped']), 'the tp = 2 step was skipped')
    require(cmp['loss_rel'] <= 1e-5 and cmp['grad_norm_rel'] <= 1e-5
            and cmp['param_max_abs_diff'] <= 2 * PAR_LR + 1e-6
            and cmp['param_share_diff_over_0.01lr'] <= 1e-3,
            f'the tp = 2 step differs from the tp = 1 step: {res}')


# ---------------------------------------------------------------------------
# E6D2_LARGE_Batch and E4D1: the other two bundled presets on the card
# ---------------------------------------------------------------------------

LARGE = 'flagfiles/E6D2_LARGE_Batch.txt'
E4D1 = 'flagfiles/E4D1.txt'
LARGE_SERVERS = (8, 64)         # streams of the two servers
LARGE_STEPS = (2, 3)            # warm-up, measured train steps
E4D1_STEPS = 2


def _preset_slice(torch, flagfile, phase, run, tok=None, shapes=None):
    """A bundled preset's StreamingDecoder (seeded random weights, as
    cli.stream builds it: step_n_frame 2) over the slice's 4 s: cuda fp32
    == the CPU run token for token, its launches (run) exactly K2 and K3
    once and K1 once per encoder layer a chunk; cuda bf16 agreement and
    per-chunk ms → (model, cfg, feat, the phase's record).  flagfile None:
    the flags' defaults; tok: its tokenizer (else one of V = 2048);
    shapes: a _recorded_shapes context for the measured cuda fp32 decode."""
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2(flagfile, tok.vocab_size if tok else 2048)
    tok = tok or StandInTokenizer(cfg.vocab_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    audio = synthetic_audio(0)
    cuda32, tok32 = _decode(model, cfg, feat, tok, audio, 'cuda', count=run,
                            shapes=shapes)
    cpu32, tok_cpu = _decode(model, cfg, feat, tok, audio, 'cpu')
    cuda16, tok16 = _decode(model, cfg, feat, tok, audio, 'cuda',
                            torch.bfloat16)
    n = STATE['chunks_' + run]
    STATE.setdefault('run_expect', {})[run] = _expect(
        mel_power=n, greedy_decode=n, lstm_fwd=cfg.enc_layers * n)
    equal = tok32.shape == tok_cpu.shape and bool((tok32 == tok_cpu).all())
    res = {'phase': phase, 'config': flagfile or 'the flags\' defaults',
           'params': sum(p.numel() for p in model.parameters()),
           'vocab': cfg.vocab_size,
           'weights': 'random, seed 0', 'audio_s': len(audio) / 16000,
           'chunk_s': cuda32.hop_size / 16000, 'frames': int(tok32.size),
           'nonblank_frames': int((tok32 != 0).sum()), 'chunks': n,
           'cuda_fp32_equals_cpu': equal,
           'chunk_ms_cuda_fp32': 1e3 * float(np.mean(cuda32.elapsed)),
           'chunk_ms_cuda_bf16': 1e3 * float(np.mean(cuda16.elapsed)),
           'chunk_ms_cpu_fp32': 1e3 * float(np.mean(cpu32.elapsed)),
           'bf16_token_agreement': _agreement(tok16, tok32)}
    if not equal:
        k, gap = _first_divergence(torch, model, cfg, feat, tok, audio,
                                   tok_cpu, tok32)
        res.update(first_diverging_frame=k, top2_gap=gap)
        emit(res)
    require(equal, f'{phase}: cuda fp32 tokens differ from the CPU run')
    require(res['nonblank_frames'] > 0, f'{phase}: no token emitted')
    return model, cfg, feat, res


def phase_large_slice(torch):
    """E6D2_LARGE_Batch's StreamingDecoder: _preset_slice, with K3's plan
    at B=1."""
    import dataclasses

    from edgedict_tpu_torch.ops import decode_kernel as K3
    model, cfg, feat, res = _preset_slice(torch, LARGE, 'large_slice',
                                          'large_decode')
    res['k3_plan'] = dataclasses.asdict(K3.card_plan(
        K3.build_decode_cache(model),
        torch.zeros(1, 1, cfg.joint_size, device='cuda'),
        torch.zeros(cfg.dec_layers, 1, cfg.dec_hidden_size, device='cuda')))
    emit(res)
    STATE['large'] = (model, cfg, feat)


def phase_large_server(torch):
    """StreamServer over MultiStreamDecoder at E6D2_LARGE_Batch, 8 and 64
    streams: _preset_servers."""
    from edgedict_tpu_torch.cli.profile_stream import StandInTokenizer
    model, cfg, feat = STATE['large']
    _preset_servers(torch, 'large_server', LARGE, model, cfg, feat,
                    StandInTokenizer(cfg.vocab_size))


def _preset_servers(torch, phase, config, model, cfg, feat, tok):
    """StreamServer over MultiStreamDecoder, 8 and 64 streams
    (LARGE_SERVERS), as cli/serve.py builds it; 4 concurrent clients of 3
    s, each transcript == its own single-stream CPU decode_wav; every K3
    launch of the rounds at B = the streams (the shape spies); its
    launches (checked with the others) one K2 and one K1 per encoder layer
    a K3 launch, no other kernel."""
    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import synthetic_audio
    audios = [synthetic_audio(10 + i, seconds=3.0) for i in range(4)]
    single = S.StreamingDecoder(model, cfg, feat, tok, device='cpu')
    expected = [single.decode_wav(a) for a in audios]
    for n in LARGE_SERVERS:
        run = f'{phase}_{n}'
        dec = S.MultiStreamDecoder(model, cfg, feat, tok, n_streams=n,
                                   device='cuda')
        logs = {}
        with _recorded_shapes(logs):
            results, server = _serve(torch, dec, audios, run)
        c = STATE['launches_' + run]
        n_k3 = c['greedy_decode']
        STATE.setdefault('run_expect', {})[run] = _expect(
            mel_power=n_k3, greedy_decode=n_k3,
            lstm_fwd=cfg.enc_layers * n_k3)
        k3_batches = sorted({key[0] for key in
                             logs['greedy_decode']['keys']})
        match = [r == e for r, e in zip(results, expected)]
        res = {'phase': phase, 'config': config, 'n_streams': dec.n,
               'clients': len(audios), 'rounds': server.rounds,
               'round_ms_mean': 1e3 * float(np.mean(dec.elapsed)),
               'k3_batches': k3_batches, 'launches': c,
               'transcripts_match_cpu': match,
               'transcript_chars': [len(r or '') for r in results]}
        emit(res)
        require(all(match), f'{run}: a transcript differs from the CPU '
                            'decode_wav')
        require(k3_batches == [n] and n_k3 > 0,
                f'{run}: K3 ran {n_k3} times at B={k3_batches}')


def _short_corpus():
    """The corpus of 128 utterances of 8-14 s (and 8 to evaluate) that
    LARGE and the flags' defaults train on (their --audio_max_length 14),
    written once beside the train_run corpus → its root."""
    tmp, _ = _train_corpus()
    root = os.path.join(tmp, 'large')
    if not os.path.isdir(root):
        train_texts, eval_texts = _corpus_texts(128, 8, seed=1)
        _synthetic_corpus(os.path.join(root, 'train'), train_texts, 300,
                          hi=14.0)
        _synthetic_corpus(os.path.join(root, 'test'), eval_texts, 700,
                          hi=14.0)
    return root


def _preset_trainer(torch, flagfile, name):
    """The port's Trainer from a bundled flagfile (None: the flags'
    defaults), built as cli/baseline.py builds it, on the smoke's synthetic
    corpus (LARGE and the defaults: _short_corpus, within their 14 s); the
    cwd is the corpus root (its BPE-2048/), restored by the caller →
    (trainer, argv, flags)."""
    from edgedict_tpu_torch.cli import baseline
    from edgedict_tpu_torch.config import parse_flags
    from edgedict_tpu_torch.trainer import Trainer
    tmp, base = _train_corpus()
    argv = ([f'--flagfile={REPO}/{flagfile}'] if flagfile else []) \
        + base[1:]
    if flagfile in (LARGE, None):
        root = _short_corpus()
        argv[argv.index('--LibriSpeech_train_100') + 1] = os.path.join(
            root, 'train')
        argv[argv.index('--LibriSpeech_test') + 1] = os.path.join(root,
                                                                  'test')
    argv += ['--name', name]
    os.chdir(tmp)                 # the BPE-2048/ cache lands in the cwd
    flags = parse_flags(baseline.build_parser(), argv)
    return Trainer(flags), argv, flags


def _preset_shapes(run, store='preset_shapes'):
    """_recorded_shapes of one run of the preset phases, into
    STATE[store][run] (phase_preset_kernels checks 'preset_shapes',
    phase_defaults_kernels 'defaults_shapes')."""
    return _recorded_shapes(STATE.setdefault(store, {}).setdefault(run, {}))


def _preset_train(torch, trainer, run, warm, measured,
                  store='preset_shapes'):
    """warm + measured run_steps over the trainer's loader (endless), the
    measured ones' launches to STATE['launches_' + run] with what their
    micro-steps imply and their kernels' shapes recorded (_preset_shapes
    into STATE[store]) → (step ms, audio s/s, losses, the last batch)."""
    def batches():
        while True:
            yield from trainer.loader
    it = batches()
    for _ in range(warm):
        float(trainer.run_step(next(it))['loss'])
    _reset_launches()
    times, audio_s, losses = [], [], []
    with _preset_shapes(run, store):
        for _ in range(measured):
            batch = next(it)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(trainer.run_step(batch)['loss']))
            times.append(time.perf_counter() - t1)
            audio_s.append(float(batch['alen'].sum()) / 16000.0)
    STATE['launches_' + run] = _launches()
    it.close()
    STATE.setdefault('run_expect', {})[run] = _train_expect(
        trainer.cfg, trainer.accum_steps * measured)
    return times, audio_s, losses, batch


def _preset_eval(torch, argv, run, eval_batch, store='preset_shapes'):
    """One cli.baseline --mode eval pass, its launches exactly what
    evaluate() implies, every K3 launch at B = eval_batch (the shape
    spies, _preset_shapes into STATE[store]) → its val_loss line and eval
    batches."""
    from edgedict_tpu_torch.cli import baseline
    lines = []
    _reset_launches()
    with _preset_shapes(run, store):
        evaluated = baseline.main(argv + ['--mode', 'eval'],
                                  log_fn=lines.append)
        torch.cuda.synchronize()
    STATE['launches_' + run] = _launches()
    STATE.setdefault('run_expect', {})[run] = _eval_expect(torch, evaluated,
                                                           0)
    val = [ln for ln in lines if ln.startswith('val_loss')]
    require(bool(val) and np.isfinite(float(val[0].split()[1])),
            f'{run}: eval printed no finite val_loss: {lines}')
    k3 = sorted({key[0] for key in
                 STATE[store][run]['greedy_decode']['keys']})
    require(k3 == [eval_batch], f'{run}: K3 ran at B={k3}')
    return val[0], len(list(evaluated.eval_loader))


def _repeated_batch_losses(trainer, batch, rows):
    """The trainer's train_step from a fresh state (seed 1), 10 times at lr
    1e-3 on the first `rows` rows of a host batch as one micro-batch →
    the losses."""
    from edgedict_tpu_torch.train import device_batch, make_train_state
    small = device_batch({k: v[:rows] for k, v in batch.items()}, 1,
                         trainer.device)
    state = make_train_state(trainer.cfg, trainer.optimizer, trainer.device,
                             seed=1)
    fall = []
    for _ in range(10):
        state, m = trainer.train_step(state, small, 1e-3, trainer.generator)
        fall.append(float(m['loss']))
    return fall


def phase_large_train_run(torch):
    """The Trainer from flagfiles/E6D2_LARGE_Batch.txt (batch 128 as 32
    micro-batches of 4, --dec_dropout 0.1, bf16, BPE 2048) on 128 synthetic
    utterances of 8-14 s: 2 warm-up and 3 measured steps (step ms,
    audio-s/s, peak memory, the busy share of one more step), the loss
    finite and falling on a repeated batch of 4, one --mode eval pass (its
    greedy decode K3 at B=4)."""
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer, argv, flags = _preset_trainer(torch, LARGE, 'large')
        setup_s = time.perf_counter() - t0
        require((flags.batch_size, trainer.accum_steps, flags.dec_dropout,
                 flags.bf16, flags.eval_batch_size) == (128, 32, 0.1, True,
                                                        4),
                f'LARGE trainer: batch {flags.batch_size}, accum '
                f'{trainer.accum_steps}, dec_dropout {flags.dec_dropout}, '
                f'bf16 {flags.bf16}')
        times, audio_s, losses, batch = _preset_train(
            torch, trainer, 'large_train', *LARGE_STEPS)
        res = {'phase': 'large_train_run', 'config': LARGE,
               'params': sum(p.numel() for p in
                             trainer.state.model.parameters()),
               'vocab': trainer.tokenizer.vocab_size,
               'batch_size': flags.batch_size, 'accum': trainer.accum_steps,
               'bf16': flags.bf16, 'dec_dropout': flags.dec_dropout,
               'utterances': len(trainer.train_dataset),
               'setup_s': setup_s,
               'batch_audio_s': [float(a) for a in audio_s],
               'step_ms': [1e3 * x for x in times],
               'step_ms_median': 1e3 * statistics.median(times),
               'audio_s_per_s_median': statistics.median(
                   a / x for a, x in zip(audio_s, times)),
               'losses': losses,
               'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
        res.update(_device_profile(torch, lambda: float(
            trainer.run_step(batch)['loss']), 1, 'step'))
        fall = res['repeated_batch_losses'] = _repeated_batch_losses(
            trainer, batch, 4)
        trainer.save()
        del trainer
        res['eval'], res['eval_batches'] = _preset_eval(
            torch, argv, 'large_train_eval', flags.eval_batch_size)
        emit(res)
        require(all(np.isfinite(losses)), 'a LARGE train loss is not finite')
        require(fall[-1] < fall[0], f'LARGE loss did not fall: {fall}')
    finally:
        os.chdir(cwd)


def phase_large_kernels(torch):
    """K3 at E6D2_LARGE_Batch's joint and prediction net (2 x 512, D 640,
    compact layout) against its plain version (k3_check: tokens exact,
    state and log-probs to 1e-4, bit-stable, timed in turns, device ms,
    bound, plan): B = 1, 4, 64 and 256 at T = 1 (streams and servers,
    <unk> 3, every frame emitting) and the eval's B = 4 at T = 214 (blank
    bias 1.8, no <unk>, log-probs)."""
    from edgedict_tpu_torch.models import transducer as T
    from edgedict_tpu_torch.ops import decode_kernel as K3
    record = STATE.get('record') or (lambda *a, **k: None)
    dev = torch.device('cuda')
    rng = np.random.RandomState(21)
    cfg, _ = _e6d2(LARGE)
    dcfg = T.TransducerConfig(vocab_size=2048, vocab_embed_size=64,
                              enc_hidden_size=8, enc_layers=1,
                              enc_proj_size=640, dec_hidden_size=512,
                              dec_layers=2, dec_proj_size=640,
                              joint_size=640)
    require((cfg.dec_hidden_size, cfg.dec_proj_size, cfg.joint_size) ==
            (512, 640, 640), 'LARGE widths changed')
    for b, t, bias, unk, logp in ((1, 1, 0.0, 3, False),
                                  (4, 1, 0.0, 3, False),
                                  (64, 1, 0.0, 3, False),
                                  (256, 1, 0.0, 3, False),
                                  (4, 214, 1.8, None, True)):
        model = T.Transducer(dcfg, device=dev, seed=1)
        with torch.no_grad():
            model.joint.out.bias[dcfg.blank] += bias
            model.joint.out.bias[3] += 0.0 if bias else 4.0     # <unk>
            h_dec0, (hs, cs) = T.decoder_apply(
                model.decoder, dcfg,
                torch.zeros((b, 0), dtype=torch.long, device=dev))
        cache = K3.build_decode_cache(model)
        f = torch.as_tensor(rng.randn(t, b, 640).astype(np.float32),
                            device=dev)
        k3_check(torch, record, (cache, f, h_dec0[:, 0].contiguous(), hs, cs,
                                 0, unk, logp), config=LARGE,
                 blank_bias=bias)


def phase_e4d1(torch):
    """flagfiles/E4D1.txt (4 x 256 encoder, hop 160, joint 256): its
    StreamingDecoder (_preset_slice), then its Trainer (batch 32 as 2
    micro-batches of 16) on the smoke's corpus: 2 measured steps (finite
    losses), the loss falling on a repeated batch of 16, one --mode eval
    pass (K3 at its eval batch 2)."""
    _, cfg, _, res = _preset_slice(torch, E4D1, 'e4d1', 'e4d1_decode')
    cwd = os.getcwd()
    try:
        trainer, argv, flags = _preset_trainer(torch, E4D1, 'e4d1')
        require((flags.batch_size, trainer.accum_steps,
                 flags.eval_batch_size) == (32, 2, 2),
                f'E4D1 trainer: batch {flags.batch_size}, accum '
                f'{trainer.accum_steps}')
        times, audio_s, losses, batch = _preset_train(torch, trainer,
                                                      'e4d1_train', 0,
                                                      E4D1_STEPS)
        fall = _repeated_batch_losses(trainer, batch, 16)
        res.update(train_params=sum(p.numel() for p in
                                    trainer.state.model.parameters()),
                   batch_size=flags.batch_size, accum=trainer.accum_steps,
                   step_ms=[1e3 * x for x in times],
                   audio_s_per_s=[a / x for a, x in zip(audio_s, times)],
                   losses=losses, repeated_batch_losses=fall)
        trainer.save()
        del trainer
        res['eval'], res['eval_batches'] = _preset_eval(
            torch, argv, 'e4d1_train_eval', flags.eval_batch_size)
    finally:
        os.chdir(cwd)
    emit(res)
    require(all(np.isfinite(losses)), f'an E4D1 train loss is not finite: '
                                      f'{losses}')
    require(fall[-1] < fall[0], f'E4D1 loss did not fall: {fall}')


def phase_preset_kernels(torch):
    """Each kernel that the preset phases' train steps and evals launched
    (large_train, large_train_eval, e4d1_train, e4d1_train_eval; recorded
    as they ran, _preset_shapes) against its plain version at the shapes
    those runs gave it: recorded_cases, each shape once across the runs,
    the first of each SYNTH_TIMED group timed (the others checked
    untimed)."""
    recorded_cases(torch, 'preset_kernels', STATE['preset_shapes'],
                   np.random.RandomState(21), seen=set(),
                   groups=SYNTH_TIMED)


DEFAULTS = None                 # no flagfile: the flags' own defaults
DEFAULTS_STEPS = (1, 2)         # warm-up, measured train steps


def _defaults_tokenizer():
    """The character tokenizer of _short_corpus's training texts (the
    defaults' --tokenizer char), built into the smoke's temp dir."""
    from edgedict_tpu_torch.tokenizer import CharTokenizer
    tmp, _ = _train_corpus()
    tok = CharTokenizer(os.path.join(tmp, 'char_defaults'))
    tok.build(_corpus_texts(128, 8, seed=1)[0])
    return tok


def phase_defaults_slice(torch):
    """The flags' defaults (no flagfile: MFCC of 80 over 128 mels, n_fft
    400, hop 200, 4 x 600 LSTM encoder, 2 x 150 prediction net, joint 512)
    at the character vocabulary of the 8-14 s corpus: _preset_slice (75 ms
    chunks of 1,400 samples; cuda fp32 == CPU; K2, K3 once and K1 four
    times a chunk), the measured decode's kernel shapes recorded, K2's
    plan at the chunk and K3's at B=1."""
    import dataclasses

    from edgedict_tpu_torch.ops import decode_kernel as K3
    from edgedict_tpu_torch.ops import features_plan as KP
    tok = _defaults_tokenizer()
    model, cfg, feat, res = _preset_slice(
        torch, DEFAULTS, 'defaults_slice', 'defaults_decode', tok,
        _preset_shapes('defaults_decode', 'defaults_shapes'))
    require((cfg.enc_layers, cfg.enc_hidden_size, cfg.dec_hidden_size,
             cfg.joint_size, feat.feature_type, feat.n_fft,
             feat.hop_length) == (4, 600, 150, 512, 'mfcc', 400, 200),
            f'the flags\' defaults changed: {cfg}, {feat}')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res['k2_plan'] = dataclasses.asdict(KP.mel_plan(
        1, 1400, feat.n_fft, feat.hop_length, feat.mfcc_n_mels, sms))
    res['k3_plan'] = dataclasses.asdict(K3.card_plan(
        K3.build_decode_cache(model),
        torch.zeros(1, 1, cfg.joint_size, device='cuda'),
        torch.zeros(cfg.dec_layers, 1, cfg.dec_hidden_size, device='cuda')))
    emit(res)
    STATE['defaults'] = (model, cfg, feat, tok)


def phase_defaults_server(torch):
    """cli.serve's StreamServer at the flags' defaults, 8 and 64 streams:
    _preset_servers."""
    model, cfg, feat, tok = STATE['defaults']
    _preset_servers(torch, 'defaults_server', 'the flags\' defaults', model,
                    cfg, feat, tok)


def phase_defaults_train_run(torch):
    """The Trainer at the flags' defaults (batch 8, one micro-batch, bf16,
    char tokenizer, dither and SpecAugment as the defaults set them) on
    _short_corpus's 8-14 s utterances: one warm-up and 2 measured steps
    (finite losses, step ms, audio-s/s), the loss falling on a repeated
    batch of 8, one --mode eval pass (K3 at B=4); both runs' kernel shapes
    recorded."""
    cwd = os.getcwd()
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer, argv, flags = _preset_trainer(torch, DEFAULTS, 'defaults')
        require((flags.batch_size, trainer.accum_steps, flags.bf16,
                 flags.tokenizer, flags.audio_max_length,
                 flags.eval_batch_size) == (8, 1, True, 'char', 14, 4),
                f'defaults trainer: batch {flags.batch_size}, accum '
                f'{trainer.accum_steps}, bf16 {flags.bf16}, tokenizer '
                f'{flags.tokenizer}')
        times, audio_s, losses, batch = _preset_train(
            torch, trainer, 'defaults_train', *DEFAULTS_STEPS,
            store='defaults_shapes')
        fall = _repeated_batch_losses(trainer, batch, 8)
        res = {'phase': 'defaults_train_run',
               'config': 'the flags\' defaults',
               'params': sum(p.numel() for p in
                             trainer.state.model.parameters()),
               'vocab': trainer.tokenizer.vocab_size,
               'batch_size': flags.batch_size,
               'utterances': len(trainer.train_dataset),
               'batch_audio_s': [float(a) for a in audio_s],
               'step_ms': [1e3 * x for x in times],
               'audio_s_per_s': [a / x for a, x in zip(audio_s, times)],
               'losses': losses, 'repeated_batch_losses': fall,
               'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}
        trainer.save()
        del trainer
        res['eval'], res['eval_batches'] = _preset_eval(
            torch, argv, 'defaults_train_eval', flags.eval_batch_size,
            'defaults_shapes')
    finally:
        os.chdir(cwd)
    emit(res)
    require(all(np.isfinite(losses)), f'a defaults train loss is not '
                                      f'finite: {losses}')
    require(fall[-1] < fall[0], f'the defaults\' loss did not fall: {fall}')


def phase_defaults_kernels(torch):
    """Each kernel that the defaults' decode, train steps and eval
    launched against its plain version at the shapes those runs gave it
    (recorded_cases: K2 at n_fft 400 in both splits through the defaults'
    MFCC tables, K1 / K4 at H=600 and 150, K3 at J=512 and the character
    vocabulary, K7 / K8 bf16 at J=512, K9 / K10 at the character labels);
    each shape once across the runs, the first of each SYNTH_TIMED group
    timed; then K2's device ms by torch.profiler at the chunk (B=1) and the
    train batch (B=8 x 14 s), n_fft 400 beside E6D2's 512 at the same
    shapes."""
    from edgedict_tpu_torch import features as F
    recorded_cases(torch, 'defaults_kernels', STATE['defaults_shapes'],
                   np.random.RandomState(23), seen=set(), groups=SYNTH_TIMED)
    record, dev = STATE['record'], torch.device('cuda')
    rng = np.random.RandomState(230)
    feat = STATE['defaults'][2]
    _, e6d2 = _e6d2()
    for cfg in (feat, e6d2):
        tables = F.FeaturePipeline(cfg, dev).tables
        for b, length in ((1, 1400), (8, 224000)):
            mel_case(torch, rng, dev, record, tables, b, length,
                     profiled=True)


def phase_server_int8_gru(torch):
    """cli.serve --quantize int8 --enc_type GRU at 64 streams (E6D2 widths,
    seeded random weights), StreamServer over MultiStreamDecoder as
    cli/serve.py builds it; 4 concurrent clients of 3 s, each transcript
    == its own single-stream CPU int8 decode_wav; its launches one K2 and
    one K3 a round, K13 once per encoder layer a round at B = 64 and K11
    on its tiled kernel for every x_proj and the projection, no other
    kernel."""
    import dataclasses

    from edgedict_tpu_torch import stream as S
    from edgedict_tpu_torch.cli.profile_stream import (
        StandInTokenizer, synthetic_audio)
    from edgedict_tpu_torch.models import transducer as T
    cfg, feat = _e6d2()
    cfg = dataclasses.replace(cfg, module_type='GRU')
    tok = StandInTokenizer(cfg.vocab_size)
    model = T.Transducer(cfg, device='cpu', seed=0)
    audios = [synthetic_audio(10 + i, seconds=3.0) for i in range(4)]
    single = S.StreamingDecoder(model, cfg, feat, tok, device='cpu',
                                quantize='int8')
    expected = [single.decode_wav(a) for a in audios]
    dec = S.MultiStreamDecoder(model, cfg, feat, tok, n_streams=64,
                               device='cuda', quantize='int8')
    run = 'server_int8_gru'
    results, server = _serve(torch, dec, audios, run)
    c = STATE['launches_' + run]
    n = c['greedy_decode']
    per_round = DECODE_RUNS['decode_wav_gru_int8']
    STATE.setdefault('run_expect', {})[run] = _expect(
        mel_power=n, greedy_decode=n, gru_fwd_q=per_round['gru_fwd_q'] * n,
        quant_matmul=per_round['quant_matmul'] * n,
        quant_matmul_tile=per_round['quant_matmul'] * n)
    match = [r == e for r, e in zip(results, expected)]
    emit({'phase': run, 'config': 'flagfiles/E6D2.txt --enc_type GRU '
                                  '--quantize int8',
          'n_streams': dec.n, 'clients': len(audios),
          'rounds': server.rounds,
          'round_ms_mean': 1e3 * float(np.mean(dec.elapsed)),
          'launches': c, 'transcripts_match_cpu': match,
          'transcript_chars': [len(r or '') for r in results]})
    require(all(match), f'{run}: a transcript differs from the CPU int8 '
                        'decode_wav')
    require(n > 0, f'{run}: no round ran')


# ---------------------------------------------------------------------------
# the synthetic-language learning run
# ---------------------------------------------------------------------------

# the trainings of phase synth_convergence: (run, the script's run()
# arguments); each at the script's widths (3 x 128 encoder, 1 x 64
# prediction net, joint 128, 40 log-mels, n_fft 400, hop 160, batch 16,
# bf16, 256 training and 48 held-out utterances unless given)
SYNTH_RUNS = (
    ('synth_lstm', dict(enc_type='LSTM', quant_ab=True)),
    ('synth_gru', dict(enc_type='GRU', quant_ab=True)),
    ('synth_beam', dict(language='confusable', noise=0.06, steps=600,
                        eval_n=64, beam=4, lm_fusion=0.8, beam_msf=4)),
    ('synth_hard', dict(language='hard', snr_sweep='inf,20,10,5,0')))
# greedy held-out WER gates: the script's exit rule (a, b) and the beam
# run's (tests/test_beam_gain.py's configuration); the beam may lose to
# greedy by at most SYNTH_BEAM_SLACK
SYNTH_GREEDY_MAX = {'synth_lstm': 0.3, 'synth_gru': 0.3, 'synth_beam': 0.35}
SYNTH_BEAM_SLACK = 0.02
# the kernels each run must launch (besides its exact counts)
SYNTH_KERNELS = ('mel_power', 'greedy_decode', 'lstm_fwd', 'lstm_bwd',
                 'joint_lse_fwd', 'joint_lse_bwd', 'lattice_alpha',
                 'lattice_beta_grad')


def _synth_expect(SC, trainer, kw, frames):
    """What one run of the script launches: per train step (one
    micro-step: batch 16 = sub-batch 16) the encoder's forward and
    backward kernel per layer (K1 / K4, or K5 / K6 for the GRU), the
    prediction net's K1 and K4 per layer, K2 and K7-K10 once; per held-out
    batch of each evaluate() (the greedy one and one per swept SNR) K2,
    K3, K7 and K9 once, the encoder's and the prediction net's forward
    twice per layer; per batch of a beam pass (without, then with the LM)
    K2 and the encoder once, the initial beam's prediction net (and LM)
    layers, and at B·W rows those layers for each of beam_msf expansions
    of every encoder frame (`frames`: the passes' frames over the held-out
    batches); the LM's LM_STEPS steps one K1 and one K4 per layer; per
    batch of each serving leg K2, K3 and the prediction net's priming K1
    per layer, and the encoder per layer (fp32, bf16), or (int8) K11 for
    each layer's x_proj and the projection (all tiled: B·T > 32 rows) and
    K12 / K13 per layer."""
    a = {**SC.DEFAULTS, **kw}
    cfg = trainer.cfg
    gru = cfg.module_type == 'GRU'
    enc_f, enc_b = ('gru_fwd', 'gru_bwd') if gru else ('lstm_fwd',
                                                        'lstm_bwd')
    n_enc, n_dec = cfg.enc_layers, cfg.dec_layers
    c = dict.fromkeys(SOURCES, 0)

    def add(**counts):
        for k, v in counts.items():
            c[k] += v

    s = a['steps']
    add(**{enc_f: s * n_enc})
    add(**{enc_b: s * n_enc})
    add(lstm_fwd=s * n_dec, lstm_bwd=s * n_dec, mel_power=s,
        joint_lse_fwd=s, joint_lse_bwd=s, lattice_alpha=s,
        lattice_beta_grad=s)
    n = a['eval_n'] // trainer.flags.eval_batch_size
    evals = 1 + len(SC._parse_snrs(a['snr_sweep']))
    add(**{enc_f: 2 * evals * n * n_enc})
    add(lstm_fwd=2 * evals * n * n_dec, mel_power=evals * n,
        greedy_decode=evals * n, joint_lse_fwd=evals * n,
        lattice_alpha=evals * n)
    if a['beam']:
        lm = a['lm_fusion'] > 0
        for layers in ((n_dec, n_dec + SC.LM_LAYERS) if lm else (n_dec,)):
            add(**{enc_f: n * n_enc})
            add(mel_power=n,
                lstm_fwd=n * layers + frames * a['beam_msf'] * layers)
        if lm:
            add(lstm_fwd=SC.LM_STEPS * SC.LM_LAYERS,
                lstm_bwd=SC.LM_STEPS * SC.LM_LAYERS)
    if a['quant_ab']:
        for _ in ('fp32', 'bf16'):
            add(**{enc_f: n * n_enc})
        add(**{'gru_fwd_q' if gru else 'lstm_fwd_q': n * n_enc})
        add(mel_power=3 * n, greedy_decode=3 * n, lstm_fwd=3 * n * n_dec,
            quant_matmul=n * (n_enc + 1), quant_matmul_tile=n * (n_enc + 1))
    return c


def _synth_frames(torch, trainer):
    """Encoder frames over the trainer's held-out batches (the beam's
    frame loop runs every frame of the padded batch).  Runs the pipeline
    (K2): call it after reading the counts."""
    frames = 0
    for batch in trainer.eval_loader:
        xs, _ = trainer.pipeline(
            torch.as_tensor(batch['audio']).to(trainer.device),
            torch.as_tensor(batch['alen']).to(trainer.device))
        frames += -(-xs.shape[1] // trainer.cfg.time_scale)
    return frames


def _synth_run(torch, SC, run, kw):
    """One call of the script's run() on cuda in a temporary logdir
    (removed afterwards), its kernel calls recorded by shape
    (STATE['synth_shapes'][run]) and its launches counted from zero:
    → (result, the trainer, its log lines, its train steps' start times,
    seconds)."""
    import tempfile

    from edgedict_tpu_torch import trainer as TR
    logdir = tempfile.mkdtemp(prefix='edgedict_synth_')
    lines, starts, built = [], [], {'beam': []}
    real_step, real_build = TR.Trainer.run_step, SC.build_run
    real_lm, real_beam = SC.train_lm, SC.beam_hyps

    def run_step(self, batch):
        starts.append(time.perf_counter())
        return real_step(self, batch)

    def build_run(args):
        built['run'] = real_build(args)
        return built['run']

    def train_lm(model, *a, **k):
        built['lm'] = model
        return real_lm(model, *a, **k)

    def beam_hyps(*a, **k):
        built['beam'].append(real_beam(*a, **k))
        return built['beam'][-1]

    TR.Trainer.run_step, SC.build_run = run_step, build_run
    SC.train_lm, SC.beam_hyps = train_lm, beam_hyps
    try:
        t0 = time.perf_counter()
        _reset_launches()
        with _recorded_shapes(STATE['synth_shapes'].setdefault(run, {}),
                              layer_widths=True, extra=True):
            result = SC.run(device='cuda', logdir=logdir,
                            log_fn=lines.append, **kw)
        torch.cuda.synchronize()
        STATE['launches_' + run] = _launches()
        seconds = time.perf_counter() - t0
    finally:
        TR.Trainer.run_step, SC.build_run = real_step, real_build
        SC.train_lm, SC.beam_hyps = real_lm, real_beam
        shutil.rmtree(logdir, ignore_errors=True)
    return result, built, lines, starts, seconds


def _cpu_beam_trainer(trainer):
    """What SC.beam_hyps reads of a trainer, for the CPU's beam search on
    a card-trained transducer: a CPU copy of its model, its held-out
    loader, and the card's features of each batch moved to the CPU."""
    import copy
    model = copy.deepcopy(trainer.eval_model()).cpu()

    def pipeline(audio, alen):
        xs, xlen = trainer.pipeline(audio.to(trainer.device),
                                    alen.to(trainer.device))
        return xs.cpu(), xlen.cpu()

    return SimpleNamespace(eval_model=lambda: model, cfg=trainer.cfg,
                           eval_loader=trainer.eval_loader,
                           pipeline=pipeline, device='cpu')


def _synth_beam_on_cpu(torch, SC, built, kw):
    """The beam run's card-trained weights (transducer and LM) decoded
    again by the CPU's beam search on the card's features of the held-out
    set, to tell the card's decoding from its training: per pass ('beam',
    then 'beam_lm') the CPU's WER, the utterances whose hypotheses differ
    from the card's, the characters the card emitted and the CPU's
    seconds.  Runs the pipeline (K2): call it after reading the counts."""
    import copy

    from edgedict_tpu_torch.metrics import wer
    trainer, tok = built['run'][:2]
    cpu = _cpu_beam_trainer(trainer)
    lm = copy.deepcopy(built['lm']).cpu()
    out = {}
    for name, (refs, card), fuse in zip(
            ('beam', 'beam_lm'), built['beam'],
            (None, (lm, SC.lm_config(tok.vocab_size), kw['lm_fusion']))):
        t0 = time.perf_counter()
        cpu_refs, hyps = SC.beam_hyps(cpu, tok, kw['beam'], kw['beam_msf'],
                                      fuse)
        out[name] = {'wer_cpu': wer(cpu_refs, hyps),
                     'utterances': len(hyps),
                     'differ': sum(a != b for a, b in zip(hyps, card)),
                     'chars_card': sum(len(h) for h in card),
                     'seconds': time.perf_counter() - t0}
    return out


# the beam run's LM held card against CPU (ROADMAP Queue 3 item 1): the
# steps whose losses and parameter gap are printed; the first
# LM_HOLD_GATED steps held to the fp32 step tolerances (PERF.md section 2:
# loss rel 1e-5, each gradient 1e-3 of its largest magnitude)
LM_HOLD_PRINTED = (1, 2, 5, 10, 50, 100, 600)
LM_HOLD_GATED = 10
LM_LOSS_RTOL, LM_GRAD_RTOL = 1e-5, 1e-3


def _rel_to_max(torch, got, want):
    """max |got - want| / max |want| (both on the CPU)."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


def _synth_lm_hold(torch, SC, built):
    """The beam run's LM trained again from its initial weights
    (LMModel(seed=LM_SEED), drawn on the CPU) over the run's lm_batches,
    on the card and on the CPU side by side, in fp32 with TF32 off (K1 / K4
    at H=64 B=8 T=32 on the card, their plain versions on the CPU).  At
    each of the first LM_HOLD_GATED steps the card's parameters before the
    step are copied to the CPU and the step's loss and gradients computed
    on both: one step's error, without the drift of the steps before it.
    At LM_HOLD_PRINTED: the two runs' losses and their largest relative
    parameter gap (max |card - CPU| / max |CPU| of each tensor, the
    largest).  → ({'held', 'printed', 'loss_card', 'loss_cpu',
    'card_equals_the_runs_lm'}, the CPU-trained LM)."""
    import copy

    from edgedict_tpu_torch import optim
    from edgedict_tpu_torch.cli.train_lm import make_lm_train_step
    from edgedict_tpu_torch.models.lm import LMModel, lm_loss
    tok, train_set = built['run'][1:3]
    cfg = SC.lm_config(tok.vocab_size)
    ids = SC.lm_ids(tok, train_set.texts())
    dev = {'card': 'cuda', 'cpu': 'cpu'}
    models = {k: LMModel(cfg, d, seed=SC.LM_SEED) for k, d in dev.items()}
    opts = {k: optim.build_optimizer('adam') for k in dev}
    states = {k: opts[k].init(dict(models[k].named_parameters()))
              for k in dev}
    steps = {k: make_lm_train_step(cfg, opts[k]) for k in dev}

    def loss_and_grads(model, ys):
        params = dict(model.named_parameters())
        ylen = torch.full((ys.shape[0],), ys.shape[1], dtype=torch.int32,
                          device=ys.device)
        loss = lm_loss(model, cfg, ys, ylen)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), {k: g.cpu()
                                      for k, g in zip(params, grads)}

    held, printed, last = [], [], {}
    for i, rows in enumerate(SC.lm_batches(ids, SC.LM_STEPS), 1):
        ys = {k: torch.from_numpy(rows).to(d) for k, d in dev.items()}
        if i <= LM_HOLD_GATED:
            lc, gc = loss_and_grads(models['card'], ys['card'])
            lp, gp = loss_and_grads(copy.deepcopy(models['card']).cpu(),
                                    ys['cpu'])
            held.append({'step': i, 'loss_card': lc, 'loss_cpu': lp,
                         'loss_rel': abs(lc - lp) / abs(lp),
                         'grad_rel_max': max(_rel_to_max(torch, gc[k],
                                                         gp[k])
                                             for k in gp)})
        for k in dev:
            states[k], loss = steps[k](models[k], states[k], ys[k],
                                       SC.LM_LR)
            last[k] = loss
        if i in LM_HOLD_PRINTED:
            card = dict(models['card'].named_parameters())
            printed.append({
                'step': i, 'loss_card': float(last['card']),
                'loss_cpu': float(last['cpu']),
                'param_rel_max': max(
                    _rel_to_max(torch, card[k].detach().cpu(), p.detach())
                    for k, p in models['cpu'].named_parameters())})
    run_lm = dict(built['lm'].named_parameters())
    return {'held': held, 'printed': printed,
            'loss_card': float(last['card']), 'loss_cpu': float(last['cpu']),
            'card_equals_the_runs_lm': all(
                torch.equal(p, run_lm[k])
                for k, p in models['card'].named_parameters())}, \
        models['cpu']


def _synth_lm_cross(torch, SC, built, kw, result, lines):
    """Queue 3 item 1, (a) and (b): the card-trained transducer decoded by
    the CPU's beam search with the LM trained on the CPU from the same
    initial weights and batches (_synth_lm_hold), beside the card's beam
    and beam + LM WERs, and the two LMs' final losses; with the LM's step
    by step hold.  Runs the pipeline (K2): call it after reading the
    counts."""
    from edgedict_tpu_torch.metrics import wer
    t0 = time.perf_counter()
    hold, cpu_lm = _synth_lm_hold(torch, SC, built)
    trainer, tok = built['run'][:2]
    fuse = (cpu_lm, SC.lm_config(tok.vocab_size), kw['lm_fusion'])
    crossed = wer(*SC.beam_hyps(_cpu_beam_trainer(trainer), tok, kw['beam'],
                                kw['beam_msf'], fuse))
    return {'beam_card': result['beam'], 'beam_lm_card': result['beam_lm'],
            'beam_lm_card_transducer_cpu_lm': crossed,
            'beam_lm <= beam with the CPU LM': crossed <= result['beam'],
            'lm_loss_card_run': _last_float(lines, 'LM trained', 'loss'),
            **hold, 'seconds': time.perf_counter() - t0}



class _PlainStandIn:
    """Calls a kernel wrapper's plain version in its place; its `launches`
    is the wrapper's own, so the wrapper, which counts through its
    module's name, still finds its count if called by a path that holds
    it (as _ShapeSpy)."""

    def __init__(self, fn, plain):
        self.fn, self.plain = fn, plain

    def __call__(self, *args, **kwargs):
        return self.plain(*args, **kwargs)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, 'launches', n))


@contextlib.contextmanager
def _plain_training_path():
    """Within: the training kernels' plain versions on the card's tensors,
    the path the CPU takes: K2 (features_kernel.mel_power), K1 and K4
    (ops/rnn_kernel.py _LSTMRecurrence: lstm_recurrence_plain forward,
    lstm_recurrence_bwd_plain backward), K7 / K8 (fused_joint_lse_plain,
    autograd through it) and K9 / K10 (the lattice core made of
    lattice_alpha_plain and lattice_beta_grad_plain), bound in every port
    module that holds them; all restored on the way out."""
    from edgedict_tpu_torch.ops import features_kernel as K2
    from edgedict_tpu_torch.ops import joint_lse_kernel as KJ
    from edgedict_tpu_torch.ops import rnn_kernel as K1
    from edgedict_tpu_torch.ops import rnnt_loss as RL
    from edgedict_tpu_torch.ops import rnnt_loss_kernel as KL
    swaps = {id(f): (f, p) for f, p in (
        (K2.mel_power, _PlainStandIn(K2.mel_power, K2.mel_power_plain)),
        (K1.lstm_recurrence_bwd, _PlainStandIn(
            K1.lstm_recurrence_bwd, K1.lstm_recurrence_bwd_plain)),
        (KJ.fused_joint_lse, KJ.fused_joint_lse_plain),
        (KL.rnnt_loss_core, RL.make_core(RL.lattice_alpha_plain,
                                         RL.lattice_beta_grad_plain)))}
    real_fwd = K1._LSTMRecurrence.forward

    def plain_fwd(ctx, x_proj, w_hh, h0, c0):
        ys, cs, h = K1.lstm_recurrence_plain(x_proj, w_hh, h0, c0)
        ctx.save_for_backward(x_proj, w_hh, h0, c0, ys, cs)
        ctx.set_materialize_grads(False)
        return ys, cs, h

    bound = []
    try:
        K1._LSTMRecurrence.forward = staticmethod(plain_fwd)
        for mod in _port_modules():
            for attr, val in list(vars(mod).items()):
                if id(val) in swaps and swaps[id(val)][0] is val:
                    setattr(mod, attr, swaps[id(val)][1])
                    bound.append((mod, attr, val))
        yield
    finally:
        K1._LSTMRecurrence.forward = real_fwd
        for mod, attr, val in bound:
            setattr(mod, attr, val)


# the beam run's transducer steps held three ways (ROADMAP Queue 3 item 1,
# (c)): the first SYNTH_HOLD_STEPS steps
SYNTH_HOLD_STEPS = 10


def _synth_transducer_hold(torch, SC, kw):
    """The beam run's first SYNTH_HOLD_STEPS bf16 train steps again from
    its seeded initial weights (a fresh build_run of its arguments, in a
    temporary logdir): before each step, the step's features computed once
    on the card (its augmentation draws, the generator then rewound), and
    the loss and gradients of those features from the same parameters by
    the card's kernels (K), the card's plain path (_plain_training_path:
    P) and the CPU's (a CPU copy of the model: C).  Per step: the loss
    relative gaps K-P (the kernels' rounding), P-C (the card's arithmetic
    against the CPU's) and K-C, and the largest gradient gap relative to
    the gradient's largest magnitude of each pair; then the kernels' step
    is taken, as the run takes it."""
    import copy
    import tempfile

    from edgedict_tpu_torch.models import transducer as TM
    logdir = tempfile.mkdtemp(prefix='edgedict_synth_hold_')
    args = argparse.Namespace(**{**SC.DEFAULTS, **kw, 'device': 'cuda',
                                 'logdir': logdir})
    out = []
    try:
        trainer = SC.build_run(args)[0]
        cfg = trainer.cfg

        def loss_and_grads(model, xs, ys, xlen, ylen):
            params = dict(model.named_parameters())
            loss = TM.transducer_loss(model, cfg, xs.to(torch.bfloat16), ys,
                                      xlen, ylen)
            grads = torch.autograd.grad(loss, list(params.values()))
            return float(loss.detach()), {k: g.float().cpu()
                                          for k, g in zip(params, grads)}

        def gaps(a, b):
            return {'loss_rel': abs(a[0] - b[0]) / abs(b[0]),
                    'grad_rel_max': max(_rel_to_max(torch, a[1][k], b[1][k])
                                        for k in b[1])}

        batches = iter(trainer.loader)
        for i in range(1, SYNTH_HOLD_STEPS + 1):
            batch = next(batches)
            dev = {k: torch.as_tensor(v).to(trainer.device)
                   for k, v in batch.items()}
            rng = trainer.generator.get_state()
            xs, xlen = trainer.pipeline(dev['audio'], dev['alen'],
                                        train=True,
                                        generator=trainer.generator)
            trainer.generator.set_state(rng)
            model = trainer.state.model
            k = loss_and_grads(model, xs, dev['ys'], xlen, dev['ylen'])
            with _plain_training_path():
                p = loss_and_grads(model, xs, dev['ys'], xlen, dev['ylen'])
            c = loss_and_grads(copy.deepcopy(model).cpu(), xs.cpu(),
                               dev['ys'].cpu(), xlen.cpu(), dev['ylen'].cpu())
            out.append({'step': i, 'loss_kernels': k[0], 'loss_card_plain':
                        p[0], 'loss_cpu': c[0],
                        'kernels_vs_card_plain': gaps(k, p),
                        'card_plain_vs_cpu': gaps(p, c),
                        'kernels_vs_cpu': gaps(k, c)})
            trainer.run_step(batch)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return out


def synth_plain_run(torch):
    """ROADMAP Queue 3 item 1, (c): the beam run's first steps held three
    ways (_synth_transducer_hold), then the run trained and decoded on the
    card's plain path (_plain_training_path) through the script's run(),
    in a temporary logdir: its held-out greedy, beam and beam + LM WERs
    and test_beam_gain.py's two claims, to set beside the kernels' run.
    Not a phase of the smoke (600 plain steps take minutes): call it alone
    after phase_build."""
    import tempfile

    from edgedict_tpu_torch.scripts import synthetic_convergence as SC
    kw = dict(SYNTH_RUNS)['synth_beam']
    emit({'phase': 'synth_plain_run', 'transducer_hold':
          _synth_transducer_hold(torch, SC, kw)})
    logdir = tempfile.mkdtemp(prefix='edgedict_synth_plain_')
    lines = []
    try:
        t0 = time.perf_counter()
        with _plain_training_path():
            result = SC.run(device='cuda', logdir=logdir,
                            log_fn=lines.append, **kw)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    emit({'phase': 'synth_plain_run', 'run': 'synth_beam', **result,
          'claims': {'beam_lm < greedy - 0.005':
                     result['beam_lm'] < result['greedy'] - 0.005,
                     'beam_lm <= beam': result['beam_lm'] <= result['beam']},
          'train_loss': _last_float(lines, 'step ', 'loss'),
          'lm_loss': _last_float(lines, 'LM trained', 'loss'),
          'seconds': seconds, 'log': lines})
    return result


def _last_float(lines, prefix, field):
    """The number after `field` in the last line that starts with
    prefix."""
    for ln in reversed(lines):
        if ln.startswith(prefix):
            words = ln.split()
            return float(words[words.index(field) + 1])
    return None


def phase_synth_convergence(torch):
    """The port's synthetic-language learning run
    (edgedict_tpu_torch/scripts/synthetic_convergence.py) through its
    run() on cuda, four trainings (SYNTH_RUNS): LSTM and GRU with the
    serving A/B (fp32 / bf16 / int8 held-out greedy WER), the confusable
    language with beam W=4 with and without LM fusion, the hard language
    with the SNR sweep.  Each: its held-out WERs, the last train loss and
    the held-out loss, the median train step wall ms (start to start), its
    seconds; gates SYNTH_GREEDY_MAX and, for the beam run, beam <= greedy +
    SYNTH_BEAM_SLACK; test_beam_gain.py's other two claims (beam_lm <
    greedy - 0.005, beam_lm <= beam) printed beside them, and the beam
    run's weights decoded again by the CPU's beam (_synth_beam_on_cpu),
    whose hypotheses must be the card's.  Its launches must equal
    _synth_expect's and include every kernel of its path."""
    from edgedict_tpu_torch.scripts import synthetic_convergence as SC
    STATE['synth_shapes'] = {}
    emit({'phase': 'synth_convergence', 'runs': {
        run: {**SC.DEFAULTS, **kw, 'device': 'cuda', 'logdir': 'temporary'}
        for run, kw in SYNTH_RUNS}})
    failed = []
    for run, kw in SYNTH_RUNS:
        result, built, lines, starts, seconds = _synth_run(
            torch, SC, run, kw)
        trainer = built['run'][0]
        got = STATE['launches_' + run]
        frames = _synth_frames(torch, trainer) if kw.get('beam') else 0
        want = _synth_expect(SC, trainer, kw, frames)
        STATE.setdefault('run_expect', {})[run] = want
        steps = np.diff(starts) * 1e3
        res = {'phase': 'synth_convergence', 'run': run, **result,
               'train_loss': _last_float(lines, 'step ', 'loss'),
               'held_out_loss': _last_float(lines, 'FINAL held-out (greedy)',
                                            'loss'),
               'lm_loss': _last_float(lines, 'LM trained', 'loss'),
               'steps': len(starts),
               'step_ms_median': float(np.median(steps)),
               'step_ms_p90': float(np.percentile(steps, 90)),
               'seconds': seconds, 'launches': got,
               'launches_expected': want, 'beam_frames': frames,
               'log': lines}
        gates = []
        if run in SYNTH_GREEDY_MAX:
            gates.append((f'greedy < {SYNTH_GREEDY_MAX[run]}',
                          result['greedy'] < SYNTH_GREEDY_MAX[run]))
        if 'beam' in result:
            gates.append((f'beam <= greedy + {SYNTH_BEAM_SLACK}',
                          result['beam']
                          <= result['greedy'] + SYNTH_BEAM_SLACK))
            res['claims'] = {
                'beam_lm < greedy - 0.005':
                    result['beam_lm'] < result['greedy'] - 0.005,
                'beam_lm <= beam': result['beam_lm'] <= result['beam']}
            res['cpu_decode'] = _synth_beam_on_cpu(torch, SC, built, kw)
            gates.append(('the CPU beam on the card-trained weights == the '
                          'card beam',
                          all(p['differ'] == 0
                              for p in res['cpu_decode'].values())))
            res['lm_cross'] = cross = _synth_lm_cross(torch, SC, built, kw,
                                                      result, lines)
            gates.append((f'the LM\'s first {LM_HOLD_GATED} steps, card '
                          f'against CPU: loss rel <= {LM_LOSS_RTOL}, '
                          f'gradients <= {LM_GRAD_RTOL} of their max',
                          all(h['loss_rel'] <= LM_LOSS_RTOL
                              and h['grad_rel_max'] <= LM_GRAD_RTOL
                              for h in cross['held'])))
        enc = ('gru_fwd', 'gru_bwd') if kw.get('enc_type') == 'GRU' else ()
        quant = (('quant_matmul', 'quant_matmul_tile',
                  'gru_fwd_q' if enc else 'lstm_fwd_q')
                 if kw.get('quant_ab') else ())
        gates.append(('exact launches', got == want))
        gates.append(('every kernel of the path launched',
                      all(got[k] > 0 for k in SYNTH_KERNELS + enc + quant)))
        res['gates'] = {name: ok for name, ok in gates}
        emit(res)
        failed += [f'{run}: {name}' for name, ok in gates if not ok]
    require(not failed, f'synth_convergence: {failed}')


# the groups of phase synth_kernels' shapes of which one (the first
# recorded) is timed: per kernel, its key without the lengths (T, U+1,
# samples)
SYNTH_TIMED = {'lstm_fwd': lambda k: (k[0], k[1], k[3]),
               'lstm_bwd': lambda k: (k[0], k[1], k[3]),
               'gru_fwd': lambda k: (k[0], k[1], k[3]),
               'gru_bwd': lambda k: (k[0], k[1], k[3]),
               'lstm_fwd_q': lambda k: (k[0], k[1], k[3]),
               'gru_fwd_q': lambda k: (k[0], k[1], k[3]),
               'mel_power': lambda k: k[0],
               'greedy_decode': lambda k: k[0],
               'joint_lse_fwd': lambda k: (k[0], k[3], k[4], k[5]),
               'lattice': lambda k: k[0]}


def phase_synth_kernels(torch):
    """Each kernel shape that synth_convergence's four runs launched
    (recorded by _recorded_shapes, with the LSTM layers' input widths and
    the GRU and int8 kernels; the spies first held against the launch
    counts) against its plain version, as in preset_kernels, each shape
    once across the runs: K1 / K4 at H=128, 64 (and the LM's 64) with one
    cuDNN layer of the recorded input width beside them, K5 / K6, K2 at
    n_fft 400, K3 at J=128, K7 / K8, K9 / K10, K11, K12, K13; every shape
    checked, the first of each SYNTH_TIMED group (and every K11 shape)
    timed."""
    recorded_cases(torch, 'synth_kernels', STATE['synth_shapes'],
                   np.random.RandomState(24), seen=set(),
                   groups=SYNTH_TIMED)



# ---------------------------------------------------------------------------
# the training soak
# ---------------------------------------------------------------------------

# phase soak: the port's soak (edgedict_tpu_torch/scripts/soak_train.py)
# at E6D2's full width, cut in depth for the smoke's time: 256 utterances
# of 8 s at batch 64 (4 steps an epoch; the checkpoints at 15 and 30 sit
# inside an epoch, so a resume skips into it; 64 x ~61 label ids a step,
# past the 3,072 where F.embedding's backward would vary from run to run),
# the kill at step 27 (0.45 of 60), resume legs of 15 steps, one
# evaluation at the end
SOAK_ARGS = ['--steps', '60', '--batch', '64', '--utts', '256',
             '--utt_seconds', '8', '--save_step', '15', '--eval_step', '60',
             '--kill_frac', '0.45', '--resume_probe_steps', '15',
             '--poll', '0.5']
SOAK_RECORD = 'EDGEDICT_SMOKE_SOAK_RECORD'   # where each leg's record goes
SOAK_KERNELS = ('mel_power', 'greedy_decode', 'lstm_fwd', 'lstm_bwd',
                'joint_lse_fwd', 'joint_lse_bwd', 'lattice_alpha',
                'lattice_beta_grad')
# the soak's legs that end by themselves (the killed one records nothing):
# their log file → the run name of their launches
SOAK_LEGS = {'probe_A.log': 'soak_probe_A', 'probe_B.log': 'soak_probe_B',
             'train.log': 'soak_final', 'device_rate.log': 'soak_device_rate'}


def soak_child():
    """One leg of phase soak, started by the soak script in place of
    cli.baseline (its flags in sys.argv[1:]): cli.baseline.main with every
    kernel call recorded by shape (_recorded_shapes, the LSTM layers' input
    widths too); at its end its launches and shapes are torch.save'd to
    $EDGEDICT_SMOKE_SOAK_RECORD/<pid>.pt, with the wall clock at this
    function's entry, after the imports, when the trainer's work begins
    (Trainer.train or the device-rate probe) and at its end.  A leg killed
    mid-run writes nothing."""
    clock = {'entry': time.time()}
    import torch

    from edgedict_tpu_torch import trainer as TR
    from edgedict_tpu_torch.cli import baseline
    clock['imported'] = time.time()
    real_train, real_rate = TR.Trainer.train, baseline.device_rate

    def train(self, *args, **kwargs):
        clock['work'] = time.time()
        return real_train(self, *args, **kwargs)

    def device_rate(*args, **kwargs):
        clock['work'] = time.time()
        return real_rate(*args, **kwargs)

    TR.Trainer.train, baseline.device_rate = train, device_rate
    logs = {}
    with _recorded_shapes(logs, layer_widths=True):
        trainer = baseline.main(sys.argv[1:])
    if trainer.device.type == 'cuda':
        torch.cuda.synchronize()
    clock['end'] = time.time()
    torch.save({'launches': _launches(), 'shapes': logs, 'clock': clock},
               os.path.join(os.environ[SOAK_RECORD], f'{os.getpid()}.pt'))


def _soak_expect(steps, eval_batches):
    """What a soak leg launches: per train step (batch = sub-batch: one
    micro-step) the 6 encoder and 2 prediction-net layers' K1 and K4,
    K2 and K7-K10 once; per held-out batch of an evaluation K2, K3, K7 and
    K9 once and the 8 layers' K1 twice (the loss, the greedy decode)."""
    c = _train_expect(SimpleNamespace(enc_layers=6, dec_layers=2), steps)
    for k in ('mel_power', 'greedy_decode', 'joint_lse_fwd',
              'lattice_alpha'):
        c[k] += eval_batches
    c['lstm_fwd'] += 16 * eval_batches
    return c


def phase_soak(torch):
    """The port's training soak through its run() at E6D2's full width (6 x
    1024 encoder, 640 projection, 2 x 256 prediction net, joint 640, 80
    log-mels, n_fft 400, hop 200, char vocabulary; bf16), SOAK_ARGS: every
    leg a cli.baseline child on cuda (soak_child in its place, to count
    and record).  Gates: the SIGKILL hit a live child (its return code
    -SIGKILL), a checkpoint survived, both resume legs' final checkpoints
    byte-identical, the final leg exited 0 at --steps, every child's log
    says 'device: cuda', no NaN-skipped loss line, loss_final <
    loss_first, the device-rate probe parsed; each leg that ended by
    itself launched exactly what its steps and evaluation imply
    (_soak_expect), every kernel of the path among them.  Prints the
    report and each leg's seconds."""
    import tempfile

    from edgedict_tpu_torch.scripts import soak_train as SOAK
    work = tempfile.mkdtemp(prefix='edgedict_soak_')
    record = os.path.join(work, 'record')
    os.makedirs(record)
    args = SOAK.build_parser().parse_args(
        SOAK_ARGS + ['--work', os.path.join(work, 'soak')])
    legs, real_launch, real_command = [], SOAK.launch, SOAK.child_command

    def launch(flags, log_path, env):
        proc, log = real_launch(flags, log_path, env)
        legs.append({'log': os.path.basename(log_path), 'proc': proc,
                     'mode': flags[flags.index('--mode') + 1],
                     't0': time.perf_counter(), 'wall': time.time()})
        return proc, log

    SOAK.launch = launch
    SOAK.child_command = lambda: [sys.executable, '-u', '-c',
                                  'import chip_smoke; chip_smoke.soak_child()']
    os.environ[SOAK_RECORD] = record
    lines = []
    try:
        t0 = time.perf_counter()
        try:
            result = SOAK.run(args, log_fn=lines.append)
        except SOAK.SoakError as e:
            raise SmokeFailure(f'soak: {e}') from e
        seconds = time.perf_counter() - t0
        logs = {name: open(os.path.join(args.work, name),
                           errors='ignore').read()
                for name in ('train.log', 'probe_A.log', 'probe_B.log',
                             'device_rate.log')}
        records = {int(f[:-3]): torch.load(os.path.join(record, f),
                                           weights_only=False)
                   for f in os.listdir(record)}
    finally:
        SOAK.launch, SOAK.child_command = real_launch, real_command
        os.environ.pop(SOAK_RECORD, None)
        shutil.rmtree(work, ignore_errors=True)
    steps_per_epoch = args.utts // args.batch
    total = -(-args.steps // steps_per_epoch) * steps_per_epoch
    probe = -(-(result['resumed_from'] + args.resume_probe_steps)
              // steps_per_epoch) * steps_per_epoch
    eval_batches = args.utts // 16
    leg_steps = {'soak_probe_A': (probe - result['resumed_from'], 0),
                 'soak_probe_B': (probe - result['resumed_from'], 0),
                 # the final leg resumes from the probes' last checkpoint
                 'soak_final': (total - probe, eval_batches),
                 'soak_device_rate': (101, 0)}
    STATE['soak_shapes'] = {}
    for leg in legs[1:]:
        run = SOAK_LEGS[leg['log']]
        rec = records.get(leg['proc'].pid)
        require(rec is not None, f'soak: leg {run} left no record')
        STATE['launches_' + run] = rec['launches']
        c = rec['clock']
        leg['seconds'] = {'to_entry': c['entry'] - leg['wall'],
                          'imports': c['imported'] - c['entry'],
                          'init': c['work'] - c['imported'],
                          'work': c['end'] - c['work']}
        STATE['soak_shapes'][run] = rec['shapes']
        STATE.setdefault('run_expect', {})[run] = _soak_expect(
            *leg_steps[run])
    got = {run: STATE['launches_' + run] for run in leg_steps}
    gates = {
        'the SIGKILL hit a live child':
            legs[0]['proc'].returncode == -signal.SIGKILL,
        'a checkpoint survived': bool(result['checkpoints']),
        'both resume legs byte-identical':
            result['double_resume_bit_identical'],
        'the final leg exited 0 at --steps':
            legs[3]['proc'].returncode == 0 and result['steps'] == total,
        'every child says device: cuda': all(
            logs[name].count('device: cuda') == n for name, n in (
                ('train.log', 2), ('probe_A.log', 1), ('probe_B.log', 1),
                ('device_rate.log', 1))),
        'no NaN-skipped loss line': result['nan_skipped_loss_lines'] == 0,
        'loss_final < loss_first':
            result['loss_final'] < result['loss_first'],
        'the device-rate probe parsed': result['device_step_ms'] is not None,
        'exact launches': all(got[run] == STATE['run_expect'][run]
                              for run in got),
        'every kernel of the path launched': all(
            sum(c[k] for c in got.values()) > 0 for k in SOAK_KERNELS)}
    emit({'phase': 'soak', 'args': SOAK_ARGS, 'report': result,
          'seconds': seconds, 'legs': [
              {'log': leg['log'], 'mode': leg['mode'],
               'returncode': leg['proc'].returncode,
               'started_s': leg['t0'] - t0, **{
                   k: leg[k] for k in ('seconds',) if k in leg}}
              for leg in legs],
          'leg_steps': leg_steps, 'launches': got,
          'launches_expected': {run: STATE['run_expect'][run]
                                for run in got},
          'log': lines, 'gates': gates})
    failed = [name for name, ok in gates.items() if not ok]
    require(not failed, f'soak: {failed}')


def phase_soak_kernels(torch):
    """Each kernel shape the soak's legs that ended by themselves launched
    (recorded in the children) against its plain version, as
    synth_kernels: K1 / K4 bf16 at H=1024 and 256 B=64 beside one cuDNN
    layer of the recorded input width, the eval's fp32 K1 at B=16, K2 at
    n_fft 400 on 64 x 8 s, K3 at J=640 and the char vocabulary, K7 / K8 and K9 / K10
    at the char vocabulary's lattices; every shape checked, the first of
    each SYNTH_TIMED group timed; then the prediction net's lookup at the
    final leg's ids (embedding_case)."""
    recorded_cases(torch, 'soak_kernels', STATE['soak_shapes'],
                   np.random.RandomState(25), seen=set(),
                   groups=SYNTH_TIMED)
    logs = STATE['soak_shapes']['soak_final']
    b, _, u1 = next(iter(logs['lattice']['keys']))
    v = next(iter(logs['joint_lse_fwd']['keys']))[4]
    embedding_case(torch, b, u1, v)


def embedding_case(torch, b, u1, v, e=64):
    """The prediction net's lookup on the card (ops/layers.py _Embedding:
    its table gradient by index_put_ with accumulate) at a soak step's
    B x (U+1) ids over its V rows and E = 64, forward and backward, against
    F.embedding's: the output bit-equal, the table gradient bit-stable over
    three calls and within 1e-5 of F.embedding's largest magnitude (the
    two sum in different orders); both timed in turns."""
    import torch.nn.functional as Fn

    from edgedict_tpu_torch.ops import layers as L
    dev = torch.device('cuda')
    g = torch.Generator().manual_seed(25)
    table = torch.randn(v, e, generator=g).to(dev).requires_grad_()
    ids = torch.randint(0, v, (b, u1), generator=g).to(dev)
    grad = torch.randn(b, u1, e, generator=g).to(dev)

    def run(fn):
        table.grad = None
        out = fn()
        out.backward(grad)
        return out, table.grad

    ker = [run(lambda: L.embedding(table, ids)) for _ in range(3)]
    ref = run(lambda: Fn.embedding(ids, table))
    torch.cuda.synchronize()
    ms, plain_ms = time_pair(torch, lambda: run(lambda: Fn.embedding(
        ids, table)), lambda: run(lambda: L.embedding(table, ids)))
    case = {'case': 'embedding', 'ids': [b, u1], 'rows': v, 'width': e,
            'output_equal': torch.equal(ker[0][0], ref[0]),
            'grad_bit_stable': all(torch.equal(ker[0][1], k[1])
                                   for k in ker[1:]),
            'grad_max_abs': float((ker[0][1] - ref[1]).abs().max()),
            'grad_max': float(ref[1].abs().max()),
            'tol': 'grad within 1e-5 of the largest |F.embedding grad|',
            'ms': ms, 'plain_ms': plain_ms}
    emit({'phase': 'soak_kernels', **case})
    require(case['output_equal'] and case['grad_bit_stable']
            and case['grad_max_abs'] <= 1e-5 * case['grad_max'],
            f'the lookup at the soak\'s ids: {case}')


SOURCES = {
    'lstm_fwd': ('edgedict_tpu_torch/csrc/rnn_fwd.cu',
                 'edgedict_tpu/ops/rnn_pallas.py:116'),
    'mel_power': ('edgedict_tpu_torch/csrc/mel_power.cu',
                  'edgedict_tpu/ops/features_pallas.py:57'),
    'greedy_decode': ('edgedict_tpu_torch/csrc/greedy_decode.cu',
                      'edgedict_tpu/ops/decode_pallas.py:131'),
    'lstm_bwd': ('edgedict_tpu_torch/csrc/rnn_bwd.cu',
                 'edgedict_tpu/ops/rnn_pallas.py:205'),
    'gru_fwd': ('edgedict_tpu_torch/csrc/rnn_fwd.cu',
                'edgedict_tpu/ops/rnn_pallas.py:462'),
    'gru_bwd': ('edgedict_tpu_torch/csrc/rnn_bwd.cu',
                'edgedict_tpu/ops/rnn_pallas.py:512'),
    'joint_lse_fwd': ('edgedict_tpu_torch/csrc/joint_lse.cu',
                      'edgedict_tpu/ops/joint_lse_pallas.py:156'),
    'joint_lse_bwd': ('edgedict_tpu_torch/csrc/joint_lse.cu',
                      'edgedict_tpu/ops/joint_lse_pallas.py:277'),
    'lattice_alpha': ('edgedict_tpu_torch/csrc/rnnt_loss.cu',
                      'edgedict_tpu/ops/rnnt_loss_pallas.py:78'),
    'lattice_beta_grad': ('edgedict_tpu_torch/csrc/rnnt_loss.cu',
                          'edgedict_tpu/ops/rnnt_loss_pallas.py:116'),
    'quant_matmul': ('edgedict_tpu_torch/csrc/quant_matmul.cu',
                     'edgedict_tpu/ops/quant.py:162'),
    'quant_matmul_tile': ('edgedict_tpu_torch/csrc/quant_matmul.cu',
                          'edgedict_tpu/ops/quant.py:162'),
    'lstm_fwd_q': ('edgedict_tpu_torch/csrc/rnn_fwd.cu',
                   'edgedict_tpu/ops/quant.py:287'),
    'gru_fwd_q': ('edgedict_tpu_torch/csrc/rnn_fwd.cu',
                  'edgedict_tpu/ops/quant.py:361'),
}
SERVING = ('mel_power', 'greedy_decode')
# per encoder call of each measured decode: the encoder kernels it must
# launch (E6D2: 6 layers; K11 for each layer's x_proj and the projection)
DECODE_RUNS = {
    'decode_wav': {'lstm_fwd': 6, 'gru_fwd': 0, 'quant_matmul': 0,
                   'lstm_fwd_q': 0, 'gru_fwd_q': 0},
    'decode_wav_int8': {'lstm_fwd': 0, 'gru_fwd': 0, 'quant_matmul': 7,
                        'quant_matmul_tile': 0, 'lstm_fwd_q': 6,
                        'gru_fwd_q': 0},
    'decode_wav_gru': {'lstm_fwd': 0, 'gru_fwd': 6, 'quant_matmul': 0,
                       'lstm_fwd_q': 0, 'gru_fwd_q': 0},
    'decode_wav_gru_int8': {'lstm_fwd': 0, 'gru_fwd': 0, 'quant_matmul': 7,
                            'quant_matmul_tile': 0, 'lstm_fwd_q': 0,
                            'gru_fwd_q': 6},
}


# each measured beam decode: (the greedy decode whose encoder kernels it
# shares per chunk, LM fusion on); per encoder frame it adds K1 for every
# prediction-net (and LM) layer at each of max_sym_per_frame expansions
BEAM_RUNS = {'beam': ('decode_wav', False), 'beam_lm': ('decode_wav', True),
             'beam_int8': ('decode_wav_int8', False)}


def check_launches():
    """The launch counts of every main-path run against what it implies."""
    runs = {run: STATE['launches_' + run] for run in
            (*DECODE_RUNS, 'server', 'server_int8', 'train', 'train_gru',
             *BEAM_RUNS, 'server_beam', 'lm_train', *STATE['run_expect'])}
    expect = {}
    for run, per_call in DECODE_RUNS.items():
        n = STATE['chunks_' + run]      # one encoder call per chunk
        expect[run] = {k: c * n for k, c in per_call.items()}
        expect[run].update(mel_power=n, greedy_decode=n)
    cfg, _ = _e6d2()
    lm_layers = STATE['beam_lm'][1].num_layers
    for run, (enc_run, lm) in BEAM_RUNS.items():
        n = STATE['chunks_' + run]
        layers = cfg.dec_layers + (lm_layers if lm else 0)
        expect[run] = {k: c * n for k, c in DECODE_RUNS[enc_run].items()}
        expect[run]['lstm_fwd'] += (STATE['frames_' + run]
                                    * BEAM['max_sym_per_frame'] * layers)
        expect[run].update(mel_power=n, greedy_decode=0)
    emit({'phase': 'launches', **runs, 'decode_expected': expect,
          'train_expected': STATE['train_expect'],
          'lm_train_expected': STATE['lm_train_expect'],
          'exact_expected': STATE['run_expect']})
    for run, want in STATE['run_expect'].items():
        require(runs[run] == want, f'{run} launches {runs[run]} != {want}')
    for run, want in expect.items():
        require(all(runs[run][k] == c for k, c in want.items()),
                f'{run} launches {runs[run]} != {want}')
    require(all(runs['server_beam'][k] > 0 for k in ('mel_power',
                                                     'lstm_fwd'))
            and runs['server_beam']['greedy_decode'] == 0,
            f'server_beam launches {runs["server_beam"]}')
    require(all(runs['lm_train'][k] == n for k, n in
                STATE['lm_train_expect'].items()),
            f'lm_train launches {runs["lm_train"]} != '
            f'{STATE["lm_train_expect"]}')
    for run, kernels in (('server', ('lstm_fwd',)),
                         ('server_int8', ('quant_matmul', 'lstm_fwd_q'))):
        require(all(runs[run][k] > 0 for k in SERVING + kernels),
                f'a kernel was not launched by {run}: {runs[run]}')
    require(runs['server_int8']['lstm_fwd'] == 0,
            f'the int8 server launched K1: {runs["server_int8"]}')
    q = runs['server_int8']
    require(q['quant_matmul_tile'] == q['quant_matmul'] > 0,
            f'the 64-stream int8 server ran K11 off its tiled kernel: {q}')
    for run, want in STATE['train_expect'].items():
        require(all(runs[run][k] == n for k, n in want.items()),
                f'{run} launches {runs[run]} != {want}')
    return runs


def main():
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 2
    try:
        import edgedict_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not importable: {e}',
              file=sys.stderr)
        return 2
    set_numerics(torch)
    phases = (('device', phase_device), ('build', phase_build),
              ('kernels', phase_kernels), ('slice', phase_slice),
              ('slice_int8', phase_slice_int8),
              ('slice_gru', phase_slice_gru), ('server', phase_server),
              ('server_int8', phase_server_int8),
              ('train_parity', phase_train_parity),
              ('train_parity_gru',
               lambda torch: phase_train_parity(torch, 'GRU')),
              ('train_run', phase_train_run),
              ('train_run_gru', lambda torch: phase_train_run(torch, 'GRU')),
              ('lm_train', phase_lm_train), ('slice_beam', phase_slice_beam),
              ('server_beam', phase_server_beam),
              ('pretrain_parity', phase_pretrain_parity),
              ('pretrain_run', phase_pretrain_run),
              ('raw_train_run', phase_raw_train_run),
              ('wav2vec_kernels', phase_wav2vec_kernels),
              ('train_features', phase_train_features),
              ('jax_checkpoint', phase_jax_checkpoint),
              ('jax_kernels', phase_jax_kernels),
              ('export', phase_export), ('apps', phase_apps),
              ('ctc', phase_ctc), ('legacy', phase_legacy),
              ('legacy_kernels', phase_legacy_kernels),
              ('surface', phase_surface), ('dp_train', phase_dp_train),
              ('server_dp', phase_server_dp), ('pp_train', phase_pp_train),
              ('tp_train', phase_tp_train),
              ('large_slice', phase_large_slice),
              ('large_server', phase_large_server),
              ('large_kernels', phase_large_kernels),
              ('large_train_run', phase_large_train_run),
              ('e4d1', phase_e4d1),
              ('preset_kernels', phase_preset_kernels),
              ('defaults_slice', phase_defaults_slice),
              ('defaults_server', phase_defaults_server),
              ('defaults_train_run', phase_defaults_train_run),
              ('defaults_kernels', phase_defaults_kernels),
              ('server_int8_gru', phase_server_int8_gru),
              ('synth_convergence', phase_synth_convergence),
              ('synth_kernels', phase_synth_kernels),
              ('soak', phase_soak), ('soak_kernels', phase_soak_kernels))
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            fn(torch)
            emit(f'phase {name} passed in {time.perf_counter() - t0:.1f} s')
        runs = check_launches()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr, flush=True)
        return 1
    finally:
        if 'train_corpus' in STATE:
            shutil.rmtree(STATE['train_corpus'][0], ignore_errors=True)
    launches = {k: sum(c[k] for c in runs.values()) for k in SOURCES}
    kernels = STATE['kernels']
    emit({'kernels': [
        {'name': name, 'route': 'cuda', 'source': SOURCES[name][0],
         'replaces': SOURCES[name][1], 'launches': launches[name],
         **{key: kernels[name][key] for key in (
             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
             'library_ms', 'device_ms', 'cases') if key in kernels[name]}}
        for name in SOURCES]})
    emit(nvidia_smi_line())
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': STATE['kind'],
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
