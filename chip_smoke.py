#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashfftconv_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py [--seed 0] [--out-dir DIR]
                          [--phases build,identity,kernels,serve,train,seq_train,parity,
                                    grad_parity,dna,dna_train,long_parity,bert,bert_train,
                                    bert_parity,gpt_serve,gpt_train,gpt_parity,window_serve,
                                    window_train,window_parity,h3_serve,h3_train,
                                    listops_train,mixers_parity,vit_serve,vit_train,
                                    vit_parity,attn_bert,attn_bert_train,attn_bert_parity,
                                    moe_train,moe_parity,sparse_parity,harness,lm_cli,
                                    cli_smoke,smem_probe,timing[,profile]]

Phases, each of which fails the run by raising:
  build     builds every CUDA kernel from csrc/ with nvcc (one nvcc per
            source, started together) and prints ptxas's register report;
            fails if an attention instance (forward, dK/dV or dQ, flash
            or splash, every head_dim), a monarch_conv, a monarch_conv_bwd
            (the direct backward's too), a dk_finish, a direct_conv
            (tensor-core forward), a band_conv, a butterfly (either
            direction), a long_conv, a long_conv_bwd, a long_dk_finish or
            a depthwise lane-window instance (forward or backward) has a
            stack frame or spills;
  identity  prints the card's name and power limit;
  kernels   holds each kernel, forward and backward, against its plain
            PyTorch version on the card, at the main paths' shapes and at
            gated, padded, odd-batch and ragged-channel shapes, with the
            tolerance printed; spectrum at every one-block FFT size (N = 16
            ... 32768), k_len 1, 3, N/2 - 1, N/2 and N, H 1, 5 and 768, row
            starts on a 16-byte boundary and not; monarch_conv at every
            one-block FFT size, k_len 1, N/2 and N, gated and not, f32 and
            bf16, L = N/2 and N - 5, rows on a 16-byte boundary and not, two
            calls bit for bit; band_conv (both conj) at
            the seq_train shape and at every N2 = 16 ... 16384 (B = 3, two
            calls bit for bit), the four-real-conv
            band route at N2 = 32768 and 131072, and the sequence-parallel
            conv at world size 1 (gated, padded, with grads) against the
            torch.fft oracle; the long kernels at every FFT size of
            LONG_SIZES in f32 and bf16, long_spectrum, long_conv_inner (also
            in place) and long_dk_finish twice bit for bit, long_spectrum
            also on two plans of an 8192-point band (F = 8 and 128); the
            direct kernels at every FFT size of DIRECT_SIZES, f32 and bf16,
            gated and not, B = 1, 3, 20 and 130 (two row blocks of the
            tensor-core forward), the backward against conv_bwd_plain with
            its dk partials grouped by bwd_group(B), both twice bit for bit;
            the three flash-attention kernels (forward, dK/dV, dQ) against
            their plain versions at the GPT-2 shape (B=8, H=12, L=1024, D=64,
            f32, causal), at D=128, at ragged L (1, 63, 65, 1000), in bf16,
            non-causal, with an ALiBi bias (and its grad), with segment ids
            from pack_sequences, and two backwards bit for bit; the same
            three non-causal at ViT-B/16's shape (B=8, H=12, L=197, D=64,
            bf16 and f32) and at BERT-base's (B=16, H=12, L=128, D=64, f32,
            segment ids of a padding mask, rows of 64-128 tokens); the three
            flash and the three splash kernels at B*H = 65792 (B=257, H=256,
            L=64, D=64, f32, causal and a window of 16), past one grid
            dimension's 65535; the six attention kernels at head_dim 256,
            384, 512, 640, 768 and 1024 (f32, bf16 with ALiBi, f16 with
            segment ids, L = 1 and 65, f32 with ALiBi at 640; windows and
            block masks; forward and backward in thread block clusters of
            D / 128 blocks up to 1024, two backwards bit for bit at 256 and
            640, flash and splash, two forwards at 256, 640 and 1024; with
            the inputs one 128-column block repeated at 768 and 1024, the
            clusters' 128-column parts of o, dk, dv and dq must agree bit
            for bit, and above 1024, at 2048, the D slices' 256-column parts;
            a row block no key is seen by at 256 and 640, whose o must be
            zeros and lse +inf; a key block no query
            sees at 256, whose dk and dv must be zeros); monarch_conv_bwd and dk_finish at every
            one-block FFT size (N = 16 ... 32768, B 1, 3, 4, 8 and 64, the dk
            spectra summed over groups of bwd_group(B) rows in thread block
            clusters, gated and not, f32 and bf16, L = N/2 and N - 5, two
            calls bit for bit); dk_finish at every one-block FFT size (N = 16
            ... 32768, B 1 and 3, ragged k_len, two calls bit for bit); the three
            splash-attention kernels (forward, dK/dV, dQ) against their plain
            versions at the windowed GPT's shapes (B=8 and B=4, H=12, L=2048,
            D=64, f32, window 256) with two backwards bit for bit, at windows
            1, 100 and >= L (which must give the causal flash kernels'
            numbers), ragged L, bf16 and D=128, at benchmarks/
            tpu_attention.py's block-sparse case (B=2, H=4, L=1024, D=128,
            bf16, 256-wide blocks, its seed-1 mask, causal), at 16-wide
            blocks not causal, and with an empty row block (exact zeros,
            finite grads); spectrum, monarch_conv and its backward with a
            kernel as long as the FFT (k_len = N) at the ListOps shape (B=64,
            H=128, L=2048, N=4096, f32), the forward against the torch.fft
            oracle; smem_probe_touch (16 KB and the largest working size) and
            smem_copy (256 MiB of f32 at 16 KB, 64 KB and the largest tile,
            and at each tile sizes below, at and just past one stage of its
            ring, also through a view 16 bytes in) against their plain
            versions bit for bit; both depthwise
            kernels at M2-BERT's and HyenaDNA's shapes and at ragged ones
            (L=100 at B=8 and 1, odd L, K=5, 7 and 9, out_len != L, BLH, f32,
            bf16, f16, an input off a 16-byte boundary), the backward twice
            bit for bit;
  serve     builds Hyena-125M (12 layers, d_model 768, l_max 8192, vocab
            50257, bf16, random weights from --seed) and answers 4 requests
            (prompts of 512..4096 tokens, 8 new tokens each, greedy) through
            utils.generation.generate, after one scoring forward; checks the
            logits are finite and that every kernel launched 12 times a forward;
  train     trains the same model (B=4, L=8192, bf16 activations, f32 master
            weights, dropout on, torch seeded from --seed) on the byte ids of
            the JAX package's Python sources (examples/lm/train.py's default
            corpus): 2 warm-up and 5 timed steps of the
            examples/lm recipe (AdamW lr 3e-4 with 2 warm-up steps, weight
            decay 0.1, clip 1.0); checks finite, falling loss and each
            kernel's launches a step; prints step time, tokens/s and peak memory;
  seq_train the same Hyena-125M with mixer_kwargs={"seq_mesh": mesh}, a
            1-rank DeviceMesh over NCCL (an in-memory store, no network): every
            long conv through parallel.seq_conv at N2 = 16384, the band_conv
            kernel. In f32 activations (the first batch, B=4, dropout on)
            its loss and grads against the plain model's (1e-3 relative, 1e-3
            of each parameter's largest |grad|); then in bf16 2 warm-up and 3
            timed steps of the train phase's recipe on its first batches, the
            first step's loss (1e-3) and grads against the plain model's on
            the same batch and dropout mask (1e-3 of each largest |grad| plus
            twice the bf16 rounding noise of a control, the plain model with
            torch.fft long convs); checks finite, falling loss and the exact
            launches a step; prints step time, tokens/s and peak memory;
  parity    a 2-layer, d_model 128, l_max 1024 Hyena LM in f32 with the same
            weights on the card (kernels) and on the CPU (plain versions):
            logits agree within 2e-3;
  grad_parity  the same LM's grads on the card (backward kernels) and on the
            CPU (plain backward) agree within 1e-3 of each parameter's
            largest |grad|, and so do the losses after one AdamW step (1e-4);
  dna       builds HyenaDNA large-1m (8 layers, d_model 256, d_inner 1024,
            l_max 1,048,576, FFT size 2,097,152, bf16, random weights from
            --seed) and answers 4 scoring requests of 131,072 to 1,048,576
            bases of the synthetic genome through models.dna.score, then 1
            warm-up and 3 timed forwards at 1,048,576 bases; checks finite
            logits and the exact launches a forward (8 long_spectrum, 8
            long_conv, 24 butterfly, 8 depthwise, no one-block conv); prints
            bits per base, forward time, tokens/ms and peak memory;
  dna_train  trains the same HyenaDNA large-1m (B=1, 1,048,576 bases, bf16
            activations, f32 master weights, no dropout, the levers of
            models.dna.train_config) on windows of the synthetic genome from
            utils.data.lm_batches: 1 warm-up and 3 timed steps of the
            examples/hyena_dna recipe (clip 1.0, AdamW lr 6e-4, weight decay
            0.1, no schedule); checks finite, falling loss and the exact
            launches a step; prints step time, tokens/s and peak memory;
  long_parity  a 2-layer, d_model 64, l_max 65536 HyenaDNA in f32 (FFT size
            131072) with the same weights on the card (long kernels) and on
            the CPU (plain versions): logits agree within 2e-3, grads within
            1e-3 of each parameter's largest |grad|, and a second backward on
            the card gives the same grads bit for bit (but the embedding
            table's, which PyTorch adds up with atomics); then a 2-layer,
            d_model 256, l_max 131072 f32 HyenaDNA on the card with every
            memory lever on against the same weights with none: loss and
            grads agree within 1e-4;
  bert      builds M2-BERT base-110M (12 layers, d_model 768, l_max 128,
            vocab 30522, dense MLP, tied MLM head, bf16, random weights from
            --seed; every long conv at FFT size 256 on the direct kernels)
            and answers 4 fill-mask requests of (B, L) = (1, 128), (8, 100),
            (32, 128) and (128, 128) over the byte ids of the JAX package's Python
            sources with 15% of positions masked, through models.bert.fill_mask,
            then 1 warm-up and 5 timed forwards at B=128, L=128; checks finite
            logits and the exact launches a forward (24 direct_conv, 24
            spectrum, 12 depthwise, no monarch_conv); prints forward time,
            tokens/ms, seqs/s and peak memory;
  bert_train  trains the same model (B=128, L=128, bf16 activations, f32
            master weights, dropout 0.1) on utils.data.mlm_batches of the same
            bytes: 2 warm-up and 5 timed steps of the examples/bert recipe
            (clip 1.0, AdamW lr 8e-4, weight decay 1e-5 on every parameter,
            the MLM loss over the masked positions); checks finite, falling
            loss and the exact launches a step; prints step time, tokens/s
            and peak memory;
  bert_parity  a 2-layer, d_model 128, l_max 128 f32 M2BertForMaskedLM with
            the same weights on the card (direct kernels) and on the CPU
            (plain versions): logits within 2e-3, masked-LM grads within 1e-3
            of each parameter's largest |grad|, and a second backward on the
            card gives the same grads bit for bit (but the embedding tables');
  gpt_serve builds GPT-2 124M (12 layers, d_model 768, 12 heads, l_max 1024,
            vocab 50257, bf16, random weights from --seed) and answers 4
            requests (prompts of 128, 256, 512 and 1000 tokens, 8 greedy new
            tokens each) through utils.generation.generate_kv (KV-cached
            decode, plain attention over the cache), then 1 warm-up and 5
            timed scoring forwards at B=8, L=1024 through the flash-attention
            kernel; checks finite logits, exactly 12 flash_attn_fwd launches a
            forward, and one request's decode-step logits with an f32 cache
            against the full forward's at the same positions (the bf16
            cache's deviation is printed beside); prints forward time,
            tokens/s and peak memory;
  gpt_train trains the same model (B=16, L=1024, bf16 activations, f32
            attention and master weights, embedding dropout 0.1) on the byte
            ids of the JAX package's Python sources: 2 warm-up and 5 timed steps of
            the examples/lm recipe (AdamW lr 3e-4 with 2 warm-up steps, weight
            decay 0.1, clip 1.0); checks finite, falling loss and exactly 12
            launches of each attention kernel a step; prints step time,
            tokens/s and peak memory;
  gpt_parity  a 2-layer f32 GPT (d_model 256, 4 heads of 64, l_max 1024) with
            the same weights on the card (attention kernels) and on the CPU
            (plain versions): logits within 2e-3, grads within 1e-3 of each
            parameter's largest |grad|, and a second backward on the card bit
            for bit (but the embedding table's);
  window_serve  builds a windowed GPT at GPT-Neo-125M's published sizes (12
            layers, d_model 768, 12 heads of 64, l_max 2048, vocab 50257,
            one window of 256 on every layer, bf16 with f32 attention, random
            weights from --seed) and answers 2 generate_kv requests of 300
            and 1500 prompt tokens (8 greedy tokens each; the second is
            longer than the window), then 1 warm-up and 5 timed scoring
            forwards at B=4, L=2048 through the splash forward kernel;
            checks finite logits, exactly 12 splash_attn_fwd and no flash
            launches a forward and none while decoding, and an f32 copy's
            decode-step logits of the 1500-token request against its full
            forward at 1e-4 of the largest |logit|; prints forward time,
            tokens/s and peak memory;
  window_train  trains the same model (B=8, L=2048) with gpt_train's recipe,
            2 warm-up and 5 timed steps; checks finite, falling loss and
            exactly 12 launches of each splash kernel and none of the flash
            kernels a step; prints step time, tokens/s and peak memory;
  window_parity  a 2-layer f32 windowed GPT (d_model 256, 4 heads of 64,
            L=2048, window 256) on the card (splash kernels) and the CPU
            (plain versions): logits within 2e-3, grads within 1e-3 of each
            parameter's largest |grad|, a second backward bit for bit (but
            the embedding table's);
  h3_serve  H3 at 125M size (examples/lm/train.py --preset hyena-125M --mixer
            h3: 12 layers, d_model 768, l_max 8192, vocab 50257, bf16, every
            layer H3 with long-conv kernels, FFT size 16384) answers the serve
            phase's 4 requests, then its forwards; checks finite logits and
            exactly 24 spectrum and 24 monarch_conv launches a forward;
  h3_train  trains it with the train phase's recipe (B=4, L=8192, 2 + 5
            steps); checks finite, falling loss and the launches a step (48
            spectrum, 24 monarch_conv, 24 monarch_conv_bwd, 24 dk_finish);
  listops_train  trains the LRA ListOps LongConvModel at the example's
            defaults (B=64, 6 layers, d_model 128, L=2048, FFT size 4096 with
            kernels of 4096 taps, dropout 0.1, one-hot over 16 tokens, a
            masked-mean pool, seeded ids of lengths 500-2048) with the
            example's optimizer (AdamW lr 4e-3, wd 0.05, the kernels at lr
            1e-3 without decay, no clip; a 2-step warm-up) for 2 + 5 steps on
            one batch; checks finite, falling loss and the launches a step;
            prints step time, tokens/s and peak memory;
  mixers_parity  2-layer f32 LMs (d_model 128) with the h3 mixer (long-conv
            kernels; shift and s4d kernels at head_dim 2), the m2 mixer with a
            block-diagonal MLP (l_max 128, direct kernels) and the long-conv
            mixer, and a 2-layer f32 ListOps LongConvModel (L=2048, k_len =
            N = 4096), on the card and the CPU: logits within 2e-3, grads
            within 1e-3 of each parameter's largest |grad|;
  vit_serve ViT-B/16 at google/vit-base-patch16-224's sizes (224 x 224
            images, patch 16: L = 197 with the cls token, d_model 768, 12
            layers, 12 heads of 64, 1000 classes, bf16 with f32 attention,
            random weights from --seed) classifies B=64 seeded images, 1
            warm-up and 5 timed forwards; checks finite logits and exactly 12
            flash forward launches a forward; prints forward time, images/s
            and peak memory;
  vit_train trains it at B=128 (DeiT-B's per-GPU batch) on one seeded batch:
            cross entropy, clip 1.0, AdamW lr 1.25e-4 (DeiT's 5e-4 x B / 512),
            weight decay 0.05, 2 warm-up and 5 timed steps; checks finite,
            falling loss and exactly 36 flash launches a step (12 forward,
            12 dK/dV, 12 dQ); prints step time, images/s and peak memory;
  vit_parity  a 2-layer f32 ViT at L=197 (d_model 256, 4 heads of 64) on
            the card and the CPU: logits within 2e-3, grads within 1e-3 of
            each parameter's largest |grad|;
  attn_bert the attention BertForMaskedLM at bert-base-uncased's sizes
            (vocab 30522, 12 layers, d_model 768, 12 heads of 64, d_inner
            3072, l_max 512, f32, random weights) takes 1 warm-up and 5 timed
            forwards at B=128, L=128 (M2-BERT's bert shape) of corpus bytes,
            row lengths drawn in 64-128 and the tails masked by
            attention_mask (segment ids), 15% masked; checks finite logits
            and 12 flash forward launches a forward; prints forward time,
            tokens/ms, seqs/s and peak memory;
  attn_bert_train  trains it with bert_train's recipe (clip 1.0, AdamW lr
            8e-4, wd 1e-5, the MLM loss, labels -100 on pads, dropout 0.1)
            for 2 warm-up and 5 timed steps; checks finite, falling loss and
            36 flash launches a step; prints step time, tokens/s and peak
            memory;
  attn_bert_parity  a 2-layer f32 attention BERT (d_model 256, 4 heads of
            64) at L=128, B=4 with padded rows on the card and the CPU:
            logits at the valid positions within 2e-3, MLM grads within 1e-3
            of each parameter's largest |grad|;
  moe_train Hyena-125M (the train phase's model) with MoE MLPs (8 experts,
            top-2, capacity 1.25; 0.52G parameters) takes the train phase's
            2 + 5 steps at B=4, L=8192; checks finite, falling loss and the
            train phase's Monarch and depthwise launches a step; prints step
            time, tokens/s, peak memory, the share of token choices dropped
            and the load-balancing loss by layer;
  moe_parity  a 2-layer f32 Hyena MoE LM (d_model 128, l_max 1024, 8
            experts, top-2) at B=2, L=128 on the card and the CPU: logits
            within 2e-3, grads within 1e-3 of each largest |grad|;
  sparse_parity  partial_fft_conv through a direct plan (N=512) and a
            Monarch plan (N=16384), and frequency_sparse_fft_conv, on the
            card against the CPU (2e-5 of the largest |y|);
  harness   the training harness at Hyena-125M's full width, in process: the
            model from utils.registry ("lm", d_model 768, 12 layers, l_max
            8192, bf16) takes 4 steps of the train phase's recipe at B=4 with
            a checkpoint (save_checkpoint) after the second; a fresh model of
            other initial weights, restored from it, takes the last two: the
            losses and every parameter must be bit-identical (each step's
            dropout masks seeded from the step); then auto_save_on_exception
            under a raised error and latest_checkpoint picking it, debug_nans
            raising on a NaN made on the card, evaluate on the ListOps
            LongConvModel over 1000 rows at B=64 (a ragged last batch)
            against a row-by-row count, and the native loader's
            restore(counter); prints the checkpoint's size and its save and
            restore seconds;
  lm_cli    examples/lm/train_torch.py --preset hyena-125M --data pystdlib
            (the corpus built from this machine's Python standard library
            into examples/lm/data/) in a subprocess, as a user runs it: 6
            steps with an eval every 3 and a checkpoint, then --resume to
            step 8; requires rc 0, the native C++ loader, "resumed at step
            6", finite val bits/byte, a sample, one JSONL record a step and
            each step's kernel launches (counted in the CLI's process);
            prints the median step time, tokens/s and peak memory beside the
            train phase's;
  cli_smoke the other five torch CLIs (hyena_dna, bert, lra listops and
            retrieval, forecasting) on the card at their JAX scripts' smoke
            test arguments, started together: each exits 0, prints its
            marker and launches its conv kernel; each timed;
  smem_probe  the shared-memory probe (utils/smem_probe.py, the counterpart
            of benchmarks/tpu_vmem_probe.py): dynamic shared memory sizes of
            16-228 KB until the first refusal, each launched size returning
            4.0, the largest equal to the opt-in attribute on the grid, then
            smem_copy at three tiles (each a ring of stages that bulk copies
            fill and drain; the log names the stages) bit for bit with
            x * 1.0001 and timed;
  timing    times each kernel, its plain version and a PyTorch yardstick
            with CUDA events at the main paths' shapes (spectrum also at
            M2-BERT's and ListOps' shapes, rows spectrum@256 and
            spectrum@4096; monarch_conv also at H3's f32-I/O shape and
            ListOps', rows monarch_conv@f32 and monarch_conv@4096, each with
            a CUDA graph's device time beside the library's); the flash
            kernels also at head_dim 256, 640 and 1024 (rows
            flash_attn_*@256, @640, @1024, B=4, H=8, L=2048, f32, causal)
            and at the encoders' training shapes (rows flash_attn_*@vit,
            B=128, H=12, L=197, D=64, f32, non-causal; flash_attn_*@bert,
            B=128, H=12, L=128, D=64, f32, padding segment ids, SDPA with the
            boolean mask);
            monarch_conv_bwd also at H3's f32-I/O shape and ListOps' (rows
            monarch_conv_bwd@f32, monarch_conv_bwd@4096), each beside the
            same kernel with one partial a row (group 1, c1_ms) and the
            whole dk path (monarch_conv_bwd + dk_finish against rfft x2,
            irfft, the batch sum and irfft); dk_finish on the partials
            monarch_conv_bwd leaves at the Hyena and ListOps shapes and at
            M2-BERT's (rows dk_finish@256, dk_finish@4096); depthwise and
            depthwise_bwd at M2-BERT's and HyenaDNA's shapes too (rows
            depthwise@bert, depthwise@dna, depthwise_bwd@bert,
            depthwise_bwd@dna), each with its device time from a CUDA graph
            beside a grouped F.conv1d's or aten.convolution_backward's; the splash kernels
            at the window_train shape beside the causal flash kernel there
            (the splash forward must take at most half its time) and SDPA
            with the dense boolean mask, the splash forward at
            tpu_attention.py's block-sparse case, and the splash forward and
            backward at head_dim 256 (rows splash_attn_fwd@256,
            splash_attn_bwd_*@256, B=4, H=8, L=2048, f32, window 256, beside
            SDPA's forward or backward with the dense mask); beside each attention
            row's f32 bound its tensor-core bound tc_bound (its
            products' operations times 3 split-TF32 passes at 494.7
            TFLOP/s), and the dK/dV + dQ pair's sum beside SDPA's backward;
            smem_copy at three tiles beside torch.mul and smem_probe_touch,
            with utils.benchmarking; long_spectrum (the chain with the
            butterfly on the taps) beside torch.fft.rfft with each one's
            device time, and its two kernels alone on the butterfly's
            bands; the forward butterfly on those f32 taps (butterfly@f32);
            long_conv_bwd gated (long_conv_bwd@gated) beside the ungated
            row; long_dk_finish's kernel alone, partials to bands
            (long_dk_finish@kernel), beside the whole call; direct_conv at
            M2-BERT's shape and at N=512, L=256
            (direct_conv@512) with tc_bound (its two dense products, 4 L N
            operations a row), monarch_conv at both shapes (monarch_conv@256,
            @512), direct_conv_bwd (the row-FFT backward) and the same
            kernel through monarch_conv_bwd (monarch_conv_bwd@256, @512) with
            the park and partials as overhead_ms, dk_finish on their 16
            partials (dk_finish@256x16, @512x16) and the whole direct
            backward (direct_bwd_chain: spectrum, direct_conv_bwd,
            dk_finish), each call's device time beside the library's;
            band_conv at the seq_train shape with its device time;
  profile   (only when named in --phases) traces one Hyena-125M forward
            and one train step with torch.profiler: device time by kernel
            and by kind, and the device's busy share of the wall time; then
            one train step of it on a 1-rank sequence mesh, one HyenaDNA
            forward and one HyenaDNA train step, then one M2-BERT forward and
            one M2-BERT train step, then one GPT-2 124M forward and train
            step, then one windowed GPT forward and train step, then one
            H3-125M forward and train step and one ListOps train step, then
            one ViT-B/16 and one BERT-base forward and train step and one
            Hyena-125M MoE train step.

Prints one JSON line of kernels (launches counted in the train phase, those
of the three long forward kernels in the dna phase, those of the two long
backward kernels in the dna_train phase, those of the direct kernels in the
bert_train phase, band_conv's in the seq_train phase, those of the flash
attention kernels in the gpt_train phase, those of the splash kernels in
the window_train phase, those of the probe kernels in the smem_probe phase),
the
card's name and power limit (nvidia-smi), then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero
with no result when there is no CUDA device or no package beside this file.
With --out-dir DIR a copy of all numbers goes to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PHASES = ("build", "identity", "kernels", "serve", "train", "seq_train", "parity",
          "grad_parity", "dna", "dna_train", "long_parity", "bert", "bert_train", "bert_parity",
          "gpt_serve", "gpt_train", "gpt_parity", "window_serve", "window_train", "window_parity",
          "h3_serve", "h3_train", "listops_train", "mixers_parity", "vit_serve", "vit_train",
          "vit_parity", "attn_bert", "attn_bert_train", "attn_bert_parity", "moe_train",
          "moe_parity", "sparse_parity", "harness", "lm_cli", "cli_smoke", "parallel_train",
          "ultra_long_cli", "smem_probe", "timing")
OPT_IN_PHASES = ("profile",)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 494.7e12  # dense TF32 tensor-core rate (NVIDIA's H100 SXM data sheet)
TF32_PASSES = 3  # split-TF32 products of f32 operands: lo hi + hi lo + hi hi
# Kernel instances that must build with no stack frame (phase_build): every
# attention kernel, monarch_conv, monarch_conv_bwd (which the direct backward
# runs too), dk_finish, the direct_conv forward on the tensor cores,
# band_conv, both butterflies, the three band kernels of the long conv
# (long_conv's, the long backward's and long_dk_finish's) and the lane-window
# bodies of the short depthwise conv, forward and backward.
STACKLESS = ("attn_fwd", "attn_bwd", "monarch_conv_kernel", "monarch_conv_bwd_kernel",
             "dkf16dk_finish_kernel", "direct_conv_tc_kernel", "band_conv_kernel",
             "butterfly_fwd_kernel", "butterfly_inv_kernel", "long_conv_kernel",
             "long_conv_bwd_kernel", "long_dk_finish_kernel", "depthwise_flat_kernel",
             "depthwise_bwd_line_kernel")

# Hyena-125M serving shapes (examples/lm/train.py preset): one forward runs
# each kernel once per layer.
B, D_MODEL, N_LAYER, L_MAX, VOCAB = 4, 768, 12, 8192, 50257
N_FFT = 2 * L_MAX
PROMPTS = (512, 1024, 2048, 4096)
NEW_TOKENS = 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# The sequence-parallel Hyena-125M at world size 1: N = N_FFT over 1 rank,
# so each long conv's band is N2 = N_FFT points.
SEQ_WARMUP, SEQ_TIMED = 2, 3
SEQ_N2 = N_FFT

# HyenaDNA large-1m serving shapes (models/dna.py preset): one forward runs
# one long conv a layer at FFT size 2 * l_max, whatever the request's length.
DNA_MODEL = "large-1m"
DNA_D_MODEL, DNA_N_LAYER, DNA_L_MAX = 256, 8, 1_048_576
DNA_N_FFT = 2 * DNA_L_MAX
DNA_REQUESTS = (131_072, 262_144, 524_288, 1_048_576)
DNA_WARMUP, DNA_TIMED = 1, 3
DNA_TRAIN_WARMUP, DNA_TRAIN_TIMED = 1, 3
LONG_SIZES = (65536, 131072, 524288, 2097152, 4194304)

# M2-BERT base-110M (examples/bert/train.py preset): every layer runs two
# long convs (the gated conv and the residual one) at FFT size 2 * l_max.
BERT_MODEL = "base-110M"
BERT_B, BERT_L, BERT_D_MODEL, BERT_N_LAYER = 128, 128, 768, 12
BERT_N_FFT = 2 * BERT_L
BERT_REQUESTS = ((1, 128), (8, 100), (32, 128), (128, 128))
BERT_WARMUP, BERT_TIMED = 1, 5
BERT_TRAIN_WARMUP, BERT_TRAIN_TIMED = 2, 5
DIRECT_SIZES = (16, 32, 64, 128, 256, 512)

# GPT-2 124M (the gpt2 checkpoint's geometry, models/gpt.py): one forward runs
# the attention kernel once a layer.
GPT_D_MODEL, GPT_N_LAYER, GPT_HEADS, GPT_L_MAX, GPT_VOCAB = 768, 12, 12, 1024, 50257
GPT_HEAD_DIM = GPT_D_MODEL // GPT_HEADS
# The head_dims above 128 that the kernels phase holds the attention kernels
# to their plain versions at: the clustered bodies (the D slices above 1024
# are checked at 2048 by _check_slices_agree).
WIDE_HEAD_DIMS = (256, 384, 512, 640, 768, 1024)
GPT_PROMPTS = (128, 256, 512, 1000)
GPT_SERVE_B, GPT_WARMUP, GPT_TIMED = 8, 1, 5
GPT_TRAIN_B, GPT_TRAIN_WARMUP, GPT_TRAIN_TIMED = 16, 2, 5

# A windowed GPT at GPT-Neo-125M's published sizes (EleutherAI gpt-neo-125M,
# config.json: hidden 768, 12 layers, 12 heads of 64, max_position_embeddings
# 2048, window_size 256, vocab 50257, learned positions, tied head, GELU),
# as the repo's GPTLMHeadModel with one window on every layer
# (mixer_kwargs={"window": 256}; GPT-Neo alternates global and local layers,
# which the JAX package does not have): a forward runs the splash forward
# once a layer.
WIN_L_MAX, WIN_W = 2048, 256
WIN_PROMPTS = (300, 1500)
WIN_SERVE_B, WIN_WARMUP, WIN_TIMED = 4, 1, 5
WIN_TRAIN_B, WIN_TRAIN_WARMUP, WIN_TRAIN_TIMED = 8, 2, 5

# H3 at 125M size: examples/lm/train.py --preset hyena-125M --mixer h3 (the
# preset's sizes above; every layer H3 with H3Operator's defaults: head_dim 1,
# long-conv kernels of l_max taps, FFT size 16384, a bf16 plan). A layer runs
# two long convs; the second at f32 I/O (k_D promotes k to f32, as in flax).
# The LRA ListOps Long Conv model (examples/lra/train_listops.py:95-120,
# 158-169 defaults): B=64, 6 layers, d_model 128, l_max 2048 (FFT size 4096,
# kernels of 4096 taps: k_len = N), dropout 0.1, kernel_lam 0.001, one-hot
# over 16 tokens (PAD 0), lengths in [500, 2048], a masked-mean pool.
LISTOPS_B, LISTOPS_LAYERS, LISTOPS_D, LISTOPS_L = 64, 6, 128, 2048
LISTOPS_VOCAB, LISTOPS_CLASSES, LISTOPS_MIN_LEN = 16, 10, 500
LISTOPS_WARMUP, LISTOPS_TIMED = 2, 5

# ViT-B/16 at google/vit-base-patch16-224's published sizes (config.json:
# image_size 224, patch_size 16, hidden 768, 12 layers, 12 heads of 64,
# intermediate 3072, 1000 classes), a cls-token classifier: L = 197 tokens,
# one flash forward a layer (its q, k, v are f32: the attention's Dense
# layers have no dtype and promote, as in flax). vit_train's B = 128 is
# DeiT-B's per-GPU batch.
VIT_IMG, VIT_PATCH, VIT_D_MODEL, VIT_N_LAYER, VIT_HEADS, VIT_CLASSES = 224, 16, 768, 12, 12, 1000
VIT_L = (VIT_IMG // VIT_PATCH) ** 2 + 1
VIT_SERVE_B, VIT_WARMUP, VIT_TIMED = 64, 1, 5
VIT_TRAIN_B, VIT_TRAIN_WARMUP, VIT_TRAIN_TIMED = 128, 2, 5
# The attention BERT at bert-base-uncased's published sizes (config.json:
# vocab 30522, hidden 768, 12 layers, 12 heads of 64, intermediate 3072,
# max_position_embeddings 512, type_vocab_size 2), f32 as the JAX default, at
# M2-BERT's shape (B = 128, L = 128) with rows of 64-128 tokens padded.
ABERT_VOCAB, ABERT_HEADS, ABERT_L_MAX, ABERT_MIN_LEN = 30522, 12, 512, 64
ABERT_WARMUP, ABERT_TIMED = 1, 5
ABERT_TRAIN_WARMUP, ABERT_TRAIN_TIMED = 2, 5
# Hyena-125M with MoE MLPs: 8 experts, top-2, the default capacity 1.25.
MOE_KWARGS = {"n_experts": 8, "top_k": 2}

KERNELS = {
    "spectrum": dict(
        source="flashfftconv_tpu_torch/csrc/spectrum.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:558",
    ),
    "monarch_conv": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:340",
    ),
    "depthwise": dict(
        source="flashfftconv_tpu_torch/csrc/depthwise.cu",
        replaces="flashfftconv_tpu/ops/depthwise.py:143",
    ),
    "monarch_conv_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1281",
    ),
    # dk_finish is the card's counterpart of _finish_dk, an XLA Monarch IDFT
    # (not a Pallas kernel) that finishes _bwd_fused_io_tiles's dk.
    "dk_finish": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:2953",
    ),
    "depthwise_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/depthwise_bwd.cu",
        replaces="flashfftconv_tpu/ops/depthwise.py:360",
    ),
    "butterfly": dict(
        source="flashfftconv_tpu_torch/csrc/butterfly.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:2074",
    ),
    # the band kernel of the long conv, counted on its wrapper long_conv_inner
    "long_conv": dict(
        source="flashfftconv_tpu_torch/csrc/long_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1928",
    ),
    "long_spectrum": dict(
        source="flashfftconv_tpu_torch/csrc/long_spectrum.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:616",
    ),
    # the band kernel of the long backward, counted on its wrapper
    # long_conv_bwd_inner
    "long_conv_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/long_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:2843",
    ),
    "long_dk_finish": dict(
        source="flashfftconv_tpu_torch/csrc/long_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:740",
    ),
    "direct_conv": dict(
        source="flashfftconv_tpu_torch/csrc/direct_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:477",
    ),
    # the row-FFT backward's instances for N <= 512, counted on its wrapper
    # direct_conv_bwd
    "direct_conv_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1460",
    ),
    # _conv_tiles in its complex contract, the sequence-parallel band conv
    "band_conv": dict(
        source="flashfftconv_tpu_torch/csrc/band_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1059",
    ),
    # JAX's Pallas flash_attention, called at ops/attention.py:202: its kernels
    # are in jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
    # the forward _flash_attention_impl (def l.589, pallas_call l.758) ...
    "flash_attn_fwd": dict(
        source="flashfftconv_tpu_torch/csrc/flash_attn.cu",
        replaces="flashfftconv_tpu/ops/attention.py:202",
    ),
    # ... _flash_attention_bwd_dkv (def l.941, pallas_call l.1121) ...
    "flash_attn_bwd_dkv": dict(
        source="flashfftconv_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="flashfftconv_tpu/ops/attention.py:202",
    ),
    # ... and _flash_attention_bwd_dq (def l.1287, pallas_call l.1456)
    "flash_attn_bwd_dq": dict(
        source="flashfftconv_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="flashfftconv_tpu/ops/attention.py:202",
    ),
    # JAX's splash attention (jax 0.9.0), which flashfftconv_tpu/ops/attention.py
    # runs through _splash_call (:268-283) for flash_mha(window=) (:186) and
    # blocksparse_mha (:340): the forward _splash_attention_forward (def
    # l.895, pallas_call l.1137) ...
    "splash_attn_fwd": dict(
        source="flashfftconv_tpu_torch/csrc/splash_attn.cu",
        replaces="jax/experimental/pallas/ops/tpu/splash_attention/"
                 "splash_attention_kernel.py:1137",
    ),
    # ... and the fused backward _splash_attention_bwd_dkv (def l.1857,
    # pallas_call l.2196; use_fused_bwd_kernel=True at ops/attention.py:264),
    # whose dk and dv the dK/dV kernel computes and whose dq (unreduced, summed
    # at l.2232-2234) the dQ kernel computes
    "splash_attn_bwd_dkv": dict(
        source="flashfftconv_tpu_torch/csrc/splash_attn_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/splash_attention/"
                 "splash_attention_kernel.py:2196",
    ),
    "splash_attn_bwd_dq": dict(
        source="flashfftconv_tpu_torch/csrc/splash_attn_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/splash_attention/"
                 "splash_attention_kernel.py:2196",
    ),
    # the VMEM probes of benchmarks/tpu_vmem_probe.py as a shared-memory probe:
    # the capacity trial (def l.42, pallas_call l.54) ...
    "smem_probe_touch": dict(
        source="flashfftconv_tpu_torch/csrc/smem_probe.cu",
        replaces="benchmarks/tpu_vmem_probe.py:54",
    ),
    # ... and the copy through large blocks (copy_kernel, pallas_call l.96)
    "smem_copy": dict(
        source="flashfftconv_tpu_torch/csrc/smem_probe.cu",
        replaces="benchmarks/tpu_vmem_probe.py:96",
    ),
}
# The phase whose run gives a kernel's launches in the JSON line.
LAUNCH_PHASE = {"butterfly": "dna", "long_conv": "dna", "long_spectrum": "dna",
                "long_conv_bwd": "dna_train", "long_dk_finish": "dna_train",
                "direct_conv": "bert_train", "direct_conv_bwd": "bert_train",
                "band_conv": "seq_train", "flash_attn_fwd": "gpt_train",
                "flash_attn_bwd_dkv": "gpt_train", "flash_attn_bwd_dq": "gpt_train",
                "splash_attn_fwd": "window_train", "splash_attn_bwd_dkv": "window_train",
                "splash_attn_bwd_dq": "window_train", "smem_probe_touch": "smem_probe",
                "smem_copy": "smem_probe"}
# The phases whose results the kernels JSON line reads.
JSON_PHASES = {"kernels", "train", "seq_train", "dna", "dna_train", "bert_train", "gpt_train",
               "window_train", "smem_probe", "timing"}
# Launches of each kernel in one Hyena-125M train step: the backward
# recomputes every long conv's kernel spectrum.
TRAIN_LAUNCHES = {"spectrum": 2 * N_LAYER, "monarch_conv": N_LAYER, "monarch_conv_bwd": N_LAYER,
                  "dk_finish": N_LAYER, "depthwise": N_LAYER, "depthwise_bwd": N_LAYER}
# Launches in one sequence-parallel Hyena-125M train step: a layer's long conv
# runs band_conv once forward and once for db in its backward (the Function
# saves its input and recomputes nothing); no Monarch conv runs.
SEQ_TRAIN_LAUNCHES = {"band_conv": 2 * N_LAYER, "depthwise": N_LAYER, "depthwise_bwd": N_LAYER,
                      "spectrum": 0, "monarch_conv": 0, "monarch_conv_bwd": 0, "dk_finish": 0}
# Launches in one HyenaDNA forward: a layer runs long_spectrum (one forward
# butterfly and its band kernel), long_conv (butterfly, band kernel, inverse
# butterfly) and the short depthwise conv; the one-block kernels never run.
DNA_LAUNCHES = {"long_spectrum": DNA_N_LAYER, "long_conv": DNA_N_LAYER,
                "butterfly": 3 * DNA_N_LAYER, "depthwise": DNA_N_LAYER, "spectrum": 0,
                "monarch_conv": 0}
# Launches in one HyenaDNA train step with every block rematerialised. A
# layer's forward and its replay in the backward each run long_spectrum (1
# butterfly), long_conv (2 butterflies) and the short conv; its backward runs
# long_spectrum again (1 butterfly), the butterflies of u and dout, the band
# backward, the inverse butterfly of du, long_dk_finish (1 inverse butterfly)
# and the short conv's backward.
DNA_TRAIN_LAUNCHES = {"long_spectrum": 3 * DNA_N_LAYER, "long_conv": 2 * DNA_N_LAYER,
                      "long_conv_bwd": DNA_N_LAYER, "long_dk_finish": DNA_N_LAYER,
                      "butterfly": 11 * DNA_N_LAYER, "depthwise": 2 * DNA_N_LAYER,
                      "depthwise_bwd": DNA_N_LAYER, "spectrum": 0, "monarch_conv": 0,
                      "monarch_conv_bwd": 0, "dk_finish": 0}
# Launches in one M2-BERT forward: a layer runs the short conv once and two
# long convs, each its kernel's spectrum and one direct_conv.
BERT_LAUNCHES = {"direct_conv": 2 * BERT_N_LAYER, "spectrum": 2 * BERT_N_LAYER,
                 "depthwise": BERT_N_LAYER, "monarch_conv": 0}
# ... and in one train step: the backward recomputes each spectrum and runs
# direct_conv_bwd and dk_finish a conv, and the short conv's backward.
BERT_TRAIN_LAUNCHES = {"direct_conv": 2 * BERT_N_LAYER, "direct_conv_bwd": 2 * BERT_N_LAYER,
                       "spectrum": 4 * BERT_N_LAYER, "dk_finish": 2 * BERT_N_LAYER,
                       "depthwise": BERT_N_LAYER, "depthwise_bwd": BERT_N_LAYER,
                       "monarch_conv": 0, "monarch_conv_bwd": 0}
# Launches in one GPT-2 forward and one train step: a layer runs the attention
# forward once, and in the backward the dK/dV and the dQ kernels once each.
GPT_LAUNCHES = {"flash_attn_fwd": GPT_N_LAYER}
GPT_TRAIN_LAUNCHES = {"flash_attn_fwd": GPT_N_LAYER, "flash_attn_bwd_dkv": GPT_N_LAYER,
                      "flash_attn_bwd_dq": GPT_N_LAYER}
# ... and in the windowed GPT: the splash kernels in place of the flash ones.
WIN_LAUNCHES = {"splash_attn_fwd": GPT_N_LAYER, "flash_attn_fwd": 0}
WIN_TRAIN_LAUNCHES = {"splash_attn_fwd": GPT_N_LAYER, "splash_attn_bwd_dkv": GPT_N_LAYER,
                      "splash_attn_bwd_dq": GPT_N_LAYER, "flash_attn_fwd": 0,
                      "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
# Launches in one ViT-B/16 or attention-BERT forward (one flash forward a
# layer) and in one train step (and the dK/dV and dQ kernels once a layer).
VIT_LAUNCHES = ABERT_LAUNCHES = {"flash_attn_fwd": VIT_N_LAYER, "flash_attn_bwd_dkv": 0,
                                 "flash_attn_bwd_dq": 0}
VIT_TRAIN_LAUNCHES = ABERT_TRAIN_LAUNCHES = {name: VIT_N_LAYER for name in VIT_LAUNCHES}
# Launches in one H3-125M forward (two long convs a layer, each its kernel's
# spectrum and one monarch_conv; no short conv) and in one train step (the
# backward recomputes each spectrum, then monarch_conv_bwd and dk_finish).
H3_LAUNCHES = {"spectrum": 2 * N_LAYER, "monarch_conv": 2 * N_LAYER, "depthwise": 0}
H3_TRAIN_LAUNCHES = {"spectrum": 4 * N_LAYER, "monarch_conv": 2 * N_LAYER,
                     "monarch_conv_bwd": 2 * N_LAYER, "dk_finish": 2 * N_LAYER, "depthwise": 0,
                     "depthwise_bwd": 0}
# ... and in one ListOps train step: one long conv a layer.
LISTOPS_TRAIN_LAUNCHES = {"spectrum": 2 * LISTOPS_LAYERS, "monarch_conv": LISTOPS_LAYERS,
                          "monarch_conv_bwd": LISTOPS_LAYERS, "dk_finish": LISTOPS_LAYERS,
                          "direct_conv": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def f32_tol(ref) -> float:
    """f32 FFT roundoff grows like log2(N) * 6e-8 (1e-6 at N = 32768) of the
    output's scale; 2e-5 of the largest |output| leaves a 20x margin."""
    return 2e-5 * float(ref.abs().max()) + 1e-7


def lowp_tol(ref) -> float:
    """Kernel and plain round the same f32 result to bf16: they may differ by
    one bf16 ulp, at most 2^-7 of the largest |output|."""
    return 2.0**-7 * float(ref.abs().max()) + 1e-6


def band_tol(ref) -> float:
    """The complex band conv runs two N2-point complex FFTs in f32 (roundoff
    about 1e-6 of max|y| at N2 = 16384) and the four-real-conv route four
    convs and their sums: held at 1e-4 of the largest |y|."""
    return 1e-4 * float(ref.abs().max()) + 1e-7


def sum_tol(abs_sum) -> float:
    """An f32 sum of many products, added in another order: its rounding is
    below 1e-5 of the sum of the terms' magnitudes (chains of < 100
    additions at 6e-8 each)."""
    return 1e-5 * float(abs_sum.abs().max()) + 1e-7


def compare(name, got, ref, tol) -> float:
    err = float((got.float() - ref.float()).abs().max())
    ok = math.isfinite(err) and err <= tol
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")
    return err


def phase_build():
    from flashfftconv_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    spilled = []
    for name in paths:
        props = None  # the function whose properties ptxas reports next
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'|(Used \d+ registers.*)|"
                          r"(\d+ bytes stack frame.*)|Function properties for (\w+)", line)
            if not m:
                continue
            if m.group(4):
                props = m.group(4)
                continue
            log(f"  {name}: {m.group(1) or m.group(2) or m.group(3)}")
            if (m.group(3) and props and any(k in props for k in STACKLESS)
                    and not m.group(3).startswith("0 bytes stack frame, 0 bytes spill stores")):
                spilled.append(f"{props}: {m.group(3)}")
    if spilled:
        raise AssertionError(f"instances of {STACKLESS} with a stack frame: {spilled}")
    return {"build_s": time.perf_counter() - t0}


def phase_identity(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()})")
    return {"device": name, "nvidia_smi": smi}


def _kernel_inputs(torch, g, dev):
    """Main-path-shaped inputs: filter taps with a slow decay, unit activations
    scaled by 0.02 as in the JAX package's tests."""
    t = torch.arange(L_MAX, dtype=torch.float32)
    k = torch.randn(D_MODEL, L_MAX, generator=g) * 0.02 * torch.exp(-t / 1000)
    u = (torch.randn(B, D_MODEL, L_MAX, generator=g) * 0.02).to(torch.bfloat16)
    x = torch.randn(B, 3 * D_MODEL, L_MAX, generator=g).to(torch.bfloat16)
    w = torch.rand(3 * D_MODEL, 3, generator=g) * 2 / math.sqrt(3 * D_MODEL)
    bias = torch.randn(3 * D_MODEL, generator=g) * 0.1
    return [a.to(dev) for a in (k, u, x, w, bias)]


def phase_kernels(torch, g):
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    errs = {}
    plan = make_plan(N_FFT, torch.bfloat16, device=dev)
    k, u, x, w, bias = _kernel_inputs(torch, g, dev)

    log(f"spectrum: H={D_MODEL} k_len={L_MAX} N={N_FFT} factors={plan.factors}")
    k_f = monarch_cuda.spectrum(plan, k)
    ref = monarch.kernel_spectrum(plan, k)
    errs["spectrum"] = compare("spectrum", torch.view_as_real(k_f), torch.view_as_real(ref),
                               f32_tol(torch.view_as_real(ref)))
    torch.cuda.synchronize()
    _check_spectrum_sizes(torch)

    log(f"monarch_conv: B={B} H={D_MODEL} L={L_MAX} N={N_FFT} bf16 ungated")
    y = monarch_cuda.monarch_conv(plan, u, k_f)
    ref = monarch.conv_with_spectrum(plan, u, k_f)
    errs["monarch_conv"] = compare("monarch_conv", y, ref, lowp_tol(ref))
    torch.cuda.synchronize()

    for n in (256, 1024, 4096, 32768):
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            b, h, length = 3, 7, n // 2 + 3
            kk = torch.randn(h, n // 2 - 1, generator=g).to(dev) * 0.1
            uu, pre, post = (torch.randn(b, h, length, generator=g).to(dev, dtype) for _ in "abc")
            kf = monarch_cuda.spectrum(p, kk)
            compare(f"spectrum N={n}", torch.view_as_real(kf),
                    torch.view_as_real(monarch.kernel_spectrum(p, kk)),
                    f32_tol(torch.view_as_real(kf)))
            yy = monarch_cuda.monarch_conv(p, uu, kf, pre, post)
            rr = monarch.conv_with_spectrum(p, uu, kf, pre, post)
            tol = f32_tol(rr) if dtype == torch.float32 else lowp_tol(rr)
            compare(f"monarch_conv gated N={n} B={b} H={h} L={length} {dtype}", yy, rr, tol)
        torch.cuda.synchronize()
    _check_monarch_conv_sizes(torch)

    log(f"depthwise: B={B} D={3 * D_MODEL} L={L_MAX} K=3 padding=(2, 0) bias bf16 BHL")
    y = dw.depthwise(x, w, bias, (2, 0), True)
    ref = dw.depthwise_plain(x, w, bias, (2, 0), True)
    errs["depthwise"] = compare("depthwise", y, ref, lowp_tol(ref))
    xb = torch.randn(2, 1000, 300, generator=g).to(dev)
    wb = torch.randn(5, 300, generator=g).to(dev) * 0.3
    bb = torch.randn(300, generator=g).to(dev)
    ref = dw.depthwise_plain(xb, wb, bb, (3, 1), False)
    compare("depthwise BLH B=2 L=1000 D=300 K=5 padding=(3, 1) f32",
            dw.depthwise(xb, wb, bb, (3, 1), False), ref, f32_tol(ref))
    torch.cuda.synchronize()
    _check_dw_shapes(torch, g)

    log(f"monarch_conv_bwd + dk_finish: B={B} H={D_MODEL} L={L_MAX} N={N_FFT} bf16 ungated")
    dout = (torch.randn(B, D_MODEL, L_MAX, generator=g) * 0.02).to(dev, torch.bfloat16)
    errs["monarch_conv_bwd"], errs["dk_finish"] = _check_conv_bwd(
        torch, plan, "main path", u, k_f, None, None, dout, L_MAX)
    for n in (256, 1024, 4096, 32768):
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, length, gated in ((3, 7, n // 2 + 3, True), (2, 5, n, False)):
                k_len = n // 2 - 1
                kf = monarch_cuda.spectrum(p, torch.randn(h, k_len, generator=g).to(dev) * 0.1)
                uu, pre, post, dd = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                                     for _ in "abcd")
                gates = (pre, post) if gated else (None, None)
                what = (f"{'gated' if gated else 'ungated'} N={n} B={b} H={h} L={length} "
                        f"k_len={k_len} {dtype}")
                _check_conv_bwd(torch, p, what, uu, kf, *gates, dd, k_len)
        torch.cuda.synchronize()
    _check_conv_bwd_sizes(torch)
    _check_dk_finish_sizes(torch)

    log(f"depthwise_bwd: B={B} D={3 * D_MODEL} L={L_MAX} K=3 padding=(2, 0) bf16 BHL")
    dy = torch.randn(x.shape, generator=g).to(dev, torch.bfloat16)
    errs["depthwise_bwd"] = _check_dw_bwd(torch, "main path", x, w, dy, (2, 0), True)
    for (b, d, length), k, pad, is_bhl, dtype in (
        ((2, 300, 1000), 5, (3, 1), False, torch.float32),
        ((2, 300, 1000), 5, (3, 1), False, torch.bfloat16),
        ((3, 37, 1031), 5, (1, 3), True, torch.float16),
        ((3, 37, 1031), 7, (0, 9), False, torch.float32),
        ((2, 64, 2048), 3, (2, 0), True, torch.float32),
    ):
        xs = (b, d, length) if is_bhl else (b, length, d)
        xx = torch.randn(xs, generator=g).to(dev, dtype)
        ww = (torch.randn((d, k) if is_bhl else (k, d), generator=g) * 0.3).to(dev)
        out_len = length + sum(pad) - k + 1
        dd = torch.randn((b, d, out_len) if is_bhl else (b, out_len, d), generator=g).to(dev, dtype)
        _check_dw_bwd(torch, f"{'BHL' if is_bhl else 'BLH'} B={b} D={d} L={length} K={k} "
                      f"padding={pad} {dtype}", xx, ww, dd, pad, is_bhl)
    torch.cuda.synchronize()
    errs.update(_check_direct_kernels(torch, g))
    errs.update(_check_long_kernels(torch, g))
    errs.update(_check_band_kernels(torch, g))
    errs.update(_check_attention_kernels(torch, g))
    errs.update(_check_splash_kernels(torch, g))
    _check_kernel_as_long_as_the_fft(torch, g)
    errs.update(_check_smem_kernels(torch, g))
    _check_operator_spread(torch)
    return errs


def _check_spectrum_sizes(torch):
    """spectrum against kernel_spectrum at every one-block plan size (N = 16
    ... 32768; the kernel has one instantiation per size), k_len 1, 3,
    N/2 - 1, N/2 and N, H 1, 5 and D_MODEL, the taps' storage on a 16-byte
    boundary and one float past it; one line a size with the worst
    err / f32_tol."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    gc = torch.Generator(device=dev).manual_seed(11)
    for n in (16 << i for i in range(12)):
        p = make_plan(n, torch.float32, device=dev)
        worst, cases = 0.0, 0
        for k_len in sorted({1, 3, n // 2 - 1, n // 2, n}):
            for h in (1, 5, D_MODEL):
                for skew in (0, 1):
                    k = torch.randn(h * k_len + skew, device=dev, generator=gc)[skew:]
                    k = k.view(h, k_len)
                    got = torch.view_as_real(monarch_cuda.spectrum(p, k))
                    ref = torch.view_as_real(monarch.kernel_spectrum(p, k))
                    err, tol = float((got - ref).abs().max()), f32_tol(ref)
                    if not (math.isfinite(err) and err <= tol):
                        raise AssertionError(f"spectrum N={n} k_len={k_len} H={h} skew={skew}: "
                                             f"kernel disagrees with its plain version "
                                             f"({err} > {tol})")
                    worst, cases = max(worst, err / tol), cases + 1
        torch.cuda.synchronize()
        log(f"  spectrum N={n}: {cases} cases (k_len 1, 3, N/2-1, N/2, N; H 1, 5, {D_MODEL}; "
            f"aligned and unaligned rows), worst err/tol {worst:.3e} ok")


def _check_monarch_conv_sizes(torch):
    """monarch_conv against conv_with_spectrum at every one-block plan size
    (N = 16 ... 32768; one instantiation per size, dtype and gating): k_len
    1, N/2 and N; gated and ungated; f32 and bf16; the rows on a 16-byte
    boundary and one element past it; L = N/2 and N - 5; two calls give the
    same bits. One line a size with the worst err / tol."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    gc = torch.Generator(device=dev).manual_seed(13)
    b, h = 3, 5
    for n in (16 << i for i in range(12)):
        p = make_plan(n, torch.float32, device=dev)
        worst, cases = 0.0, 0
        for k_len in sorted({1, n // 2, n}):
            k_f = monarch_cuda.spectrum(p, torch.randn(h, k_len, device=dev, generator=gc) * 0.1)
            for dtype in (torch.float32, torch.bfloat16):
                for length in (n // 2, n - 5):
                    for gated in (False, True):
                        for skew in (0, 1):
                            u, pre, post = (torch.randn(b * h * length + skew, device=dev,
                                                        generator=gc).to(dtype)[skew:]
                                            .view(b, h, length) for _ in "abc")
                            gates = (pre, post) if gated else ()
                            y = monarch_cuda.monarch_conv(p, u, k_f, *gates)
                            again = monarch_cuda.monarch_conv(p, u, k_f, *gates)
                            ref = monarch.conv_with_spectrum(p, u, k_f, *gates)
                            tol = f32_tol(ref) if dtype == torch.float32 else lowp_tol(ref)
                            err = float((y.float() - ref.float()).abs().max())
                            what = (f"monarch_conv N={n} k_len={k_len} {dtype} L={length} "
                                    f"gated={gated} skew={skew}")
                            if not (math.isfinite(err) and err <= tol):
                                raise AssertionError(f"{what}: kernel disagrees with its plain "
                                                     f"version ({err} > {tol})")
                            if not torch.equal(y, again):
                                raise AssertionError(f"{what}: two calls differ")
                            worst, cases = max(worst, err / tol), cases + 1
        torch.cuda.synchronize()
        log(f"  monarch_conv N={n}: {cases} cases (k_len 1, N/2, N; f32, bf16; L = N/2, N-5; "
            f"gated, ungated; aligned and unaligned rows; two calls bit for bit), worst "
            f"err/tol {worst:.3e} ok")


def _check_conv_bwd_sizes(torch):
    """monarch_conv_bwd and dk_finish against conv_bwd_plain and
    dk_finish_plain at every one-block plan size (N = 16 ... 32768; one
    instantiation per size, dtype and gating): B 1, 3, 4, 8 and 64 (the dk
    spectra summed in groups of 1, 1, 4, 8 and 8 rows, in thread block
    clusters), gated and ungated, f32 and bf16, L = N/2 and N - 5 (rows off
    16-byte boundaries); the partials against the plain version's grouped
    ones; two calls give the same bits. One line a size with the worst
    err / tol."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    gc = torch.Generator(device=dev).manual_seed(15)
    for n in (16 << i for i in range(12)):
        p = make_plan(n, torch.float32, device=dev)
        k_len = max(1, n // 2 - 1)
        worst, cases = 0.0, 0
        for b in (1, 3, 4, 8, 64):
            h = 2 if b == 64 else 5
            k_f = monarch_cuda.spectrum(p, torch.randn(h, k_len, device=dev, generator=gc) * 0.1)
            for length, dtype, gated in itertools.product(
                    (n // 2, n - 5), (torch.float32, torch.bfloat16), (False, True)):
                u, d, pre, post = (torch.randn(b, h, length, device=dev, generator=gc).to(dtype)
                                   for _ in "abcd")
                gates = (pre, post) if gated else (None, None)
                got = monarch_cuda.monarch_conv_bwd(p, u, k_f, *gates, d)
                again = monarch_cuda.monarch_conv_bwd(p, u, k_f, *gates, d)
                ref = monarch.conv_bwd_plain(p, u, k_f, *gates, d)
                dk = monarch_cuda.dk_finish(p, got[3], k_len)
                what = (f"monarch_conv_bwd N={n} B={b} H={h} L={length} {dtype} "
                        f"gated={gated}")
                pairs = [*zip(("du", "dpre", "dpost"), got[:3], ref[:3]),
                         ("partials", torch.view_as_real(got[3]), torch.view_as_real(ref[3])),
                         ("dk", dk, monarch.dk_finish_plain(p, ref[3], k_len))]
                for name, a, r in pairs:
                    if r is None:
                        continue
                    tol = lowp_tol(r) if a.dtype == torch.bfloat16 else f32_tol(r)
                    if a.shape != r.shape:
                        raise AssertionError(f"{what}: {name} shape {tuple(a.shape)} != "
                                             f"{tuple(r.shape)}")
                    err = float((a.float() - r.float()).abs().max())
                    if not (math.isfinite(err) and err <= tol):
                        raise AssertionError(f"{what}: {name} disagrees with its plain version "
                                             f"({err} > {tol})")
                    worst = max(worst, err / tol)
                if not (all(x is None or torch.equal(x, y) for x, y in zip(got, again))
                        and torch.equal(dk, monarch_cuda.dk_finish(p, again[3], k_len))):
                    raise AssertionError(f"{what}: two calls differ")
                cases += 1
        torch.cuda.synchronize()
        log(f"  monarch_conv_bwd + dk_finish N={n}: {cases} cases (B 1, 3, 4, 8, 64; L = N/2, "
            f"N-5; f32, bf16; gated, ungated; grouped partials; two calls bit for bit), worst "
            f"err/tol {worst:.3e} ok")


def _check_dk_finish_sizes(torch):
    """dk_finish against dk_finish_plain at every one-block plan size (N = 16
    ... 32768; one instantiation per size): B 1 and 3, k_len 1, N/2 - 1, N/2
    and N, dk rows on 16-byte boundaries and not (an odd k_len); two calls
    give the same bits. One line a size with the worst err / tol."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    gc = torch.Generator(device=dev).manual_seed(14)
    for n in (16 << i for i in range(12)):
        p = make_plan(n, torch.float32, device=dev)
        worst, cases = 0.0, 0
        for b, h in ((1, 5), (3, 7)):
            parts = torch.view_as_complex(torch.randn(b, h, n // 2 + 1, 2, device=dev,
                                                      generator=gc))
            for k_len in sorted({1, max(1, n // 2 - 1), n // 2, n}):
                dk = monarch_cuda.dk_finish(p, parts, k_len)
                again = monarch_cuda.dk_finish(p, parts, k_len)
                ref = monarch.dk_finish_plain(p, parts, k_len)
                tol, err = f32_tol(ref), float((dk - ref).abs().max())
                what = f"dk_finish N={n} B={b} H={h} k_len={k_len}"
                if not (math.isfinite(err) and err <= tol):
                    raise AssertionError(f"{what}: kernel disagrees with its plain version "
                                         f"({err} > {tol})")
                if not torch.equal(dk, again):
                    raise AssertionError(f"{what}: two calls differ")
                worst, cases = max(worst, err / tol), cases + 1
        torch.cuda.synchronize()
        log(f"  dk_finish N={n}: {cases} cases (B 1, 3; k_len 1, N/2-1, N/2, N; two calls bit "
            f"for bit), worst err/tol {worst:.3e} ok")


def _check_kernel_as_long_as_the_fft(torch, g):
    """spectrum, monarch_conv, monarch_conv_bwd and dk_finish at the ListOps
    shape (B=64, H=128, L=2048, N=4096, f32 I/O) with k_len = N, the taps'
    second half reaching the output by the circular wrap: the forward against
    the torch.fft oracle (fft_conv_reference), the backward against the plain
    versions."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    n = 2 * LISTOPS_L
    dev = torch.device("cuda")
    plan = make_plan(n, torch.bfloat16, device=dev)
    k = (torch.randn(LISTOPS_D, n, generator=g) * 0.02).to(dev)
    u = torch.randn(LISTOPS_B, LISTOPS_D, LISTOPS_L, generator=g).to(dev)
    log(f"k_len = N: B={LISTOPS_B} H={LISTOPS_D} L={LISTOPS_L} N={n} k_len={n} f32")
    k_f = monarch_cuda.spectrum(plan, k)
    ref = monarch.kernel_spectrum(plan, k)
    compare("spectrum k_len = N", torch.view_as_real(k_f), torch.view_as_real(ref),
            f32_tol(torch.view_as_real(ref)))
    ref = monarch.fft_conv_reference(n, u, k)
    compare("monarch_conv k_len = N against fft_conv_reference",
            monarch_cuda.monarch_conv(plan, u, k_f), ref, f32_tol(ref))
    dout = torch.randn(u.shape, generator=g).to(dev)
    _check_conv_bwd(torch, plan, "k_len = N", u, k_f, None, None, dout, n)
    torch.cuda.synchronize()


def _check_smem_kernels(torch, g):
    """smem_probe_touch at 16 KB and the largest working size, and smem_copy
    over 256 MiB of f32 at 16 KB, 64 KB and the largest tile, against their
    plain versions bit for bit (the touch adds x*2 and x+1, the copy is one
    f32 multiply: both exact in the same order); at each tile smem_copy also
    at sizes below one stage, of one stage and of a stage and a float4 (a
    last chunk of 16 bytes), each at a view 16 bytes into its buffer too, on
    NaN-filled outputs (_poison)."""
    from flashfftconv_tpu_torch.utils import smem_probe as sp

    best = sp.grid_floor(sp.device_attrs("cuda")["max_shared_per_block_optin"])
    x = torch.randn(sp.PROBE_SHAPE, generator=g).cuda()
    errs = {}
    for nbytes in (16 * 1024, best):
        errs["smem_probe_touch"] = compare(f"smem_probe_touch {nbytes} B", sp.smem_probe_touch(
            x, nbytes), sp.touch_plain(x), 0.0)
    src = torch.randn(sp.COPY_BYTES // 4 + 4, generator=g).cuda()
    for tile in (16 * 1024, 64 * 1024, best):
        whole = src[: sp.COPY_BYTES // 4]
        errs["smem_copy"] = compare(f"smem_copy {tile} B tiles over 256 MiB f32",
                                    sp.smem_copy(whole, tile), sp.copy_plain(whole), 0.0)
        stage = sp.copy_stages(tile)[1] // 4
        for n in (4, 1000, stage - 4, stage, stage + 4):
            for off in (0, 4):
                x = src[off:off + n]
                _poison(torch, x)
                errs["smem_copy"] = max(errs["smem_copy"], compare(
                    f"smem_copy {tile} B tiles, {n} f32 at offset {4 * off} B",
                    sp.smem_copy(x, tile), sp.copy_plain(x), 0.0))
    torch.cuda.synchronize()
    return errs


def attn_tol(ref) -> float:
    """An attention output or grad against its plain version: in f32 the two
    sum the same products in another order (the forward also rescales by the
    online softmax), 2e-5 of the largest |value| or of 1 where that is
    smaller (grads that are 0 up to rounding, as dq and dk at L = 1, round to
    about 1e-6); in bf16 both round the same f32 value once, one ulp of the
    largest |value|."""
    if ref.element_size() == 2:
        return lowp_tol(ref)
    return 2e-5 * max(1.0, float(ref.float().abs().max()))


def _attn_inputs(torch, g, dev, b, h, l, d, dtype):
    return [torch.randn(b, h, l, d, generator=g).to(dev, dtype) for _ in range(4)]


def _check_attention(torch, what, q, k, v, do, causal, bias=None, seg=None):
    """flash_attn_fwd, flash_attn_bwd_dkv and flash_attn_bwd_dq against the
    plain forward and backward on the same inputs; the dQ kernel's ds (the
    bias's grad) too when there is a bias. Returns the three largest errors."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    o, lse = ac.flash_attn_fwd(q, k, v, causal, None, bias, seg)
    ro, rlse = plain.flash_attn_fwd_plain(q, k, v, causal, None, bias, seg)
    e_fwd = max(compare(f"flash_attn_fwd {what}", o, ro, attn_tol(ro)),
                compare(f"flash_attn_fwd lse {what}", lse, rlse, f32_tol(rlse)))
    delta = plain.attention_delta(o, do)
    dk, dv = ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, causal, None, bias, seg)
    dq, ds = ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, causal, None, bias, seg,
                                  bias_grad=bias is not None)
    rq, rk, rv, rds = plain.flash_attn_bwd_plain(q, k, v, o, lse, do, causal, None, bias, seg,
                                                 bias is not None)
    e_dkv = max(compare(f"flash_attn_bwd_dkv dk {what}", dk, rk, attn_tol(rk)),
                compare(f"flash_attn_bwd_dkv dv {what}", dv, rv, attn_tol(rv)))
    e_dq = compare(f"flash_attn_bwd_dq dq {what}", dq, rq, attn_tol(rq))
    if bias is not None:
        e_dq = max(e_dq, compare(f"flash_attn_bwd_dq ds {what}", ds, rds, attn_tol(rds)))
    torch.cuda.synchronize()
    return e_fwd, e_dkv, e_dq


def _padding_segments(torch, g, b, l, dev):
    """int32 (b, l) segment ids of a padding mask: 1 on a row's first n
    positions (n drawn in [ABERT_MIN_LEN, l]), 0 on its padded tail."""
    n = torch.randint(ABERT_MIN_LEN, l + 1, (b, 1), generator=g)
    return (torch.arange(l)[None] < n).int().to(dev)


def _check_attention_kernels(torch, g):
    """The attention kernels at the GPT-2 shapes of the main path (H=12,
    L=1024, D=64, f32, causal; B=8 as gpt_serve's forwards give it, B=16 as
    gpt_train's steps give all three), with two backwards bit for bit at
    each; then at D=128, ragged L, bf16, non-causal, ALiBi, packed segment
    ids, and at B*H = 65792 (past one grid dimension); and
    FlashAttnFunction's grads (the bias's summed to its shape) against
    autograd through mha_reference."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    errs = {"flash_attn_fwd": 0.0, "flash_attn_bwd_dkv": 0.0, "flash_attn_bwd_dq": 0.0}
    h, l, d = GPT_HEADS, GPT_L_MAX, GPT_HEAD_DIM
    for b, path in ((GPT_SERVE_B, "gpt_serve"), (GPT_TRAIN_B, "gpt_train")):
        log(f"flash attention: B={b} H={h} L={l} D={d} f32 causal (the GPT-2 shape of {path})")
        q, k, v, do = _attn_inputs(torch, g, dev, b, h, l, d, torch.float32)
        got = _check_attention(torch, f"GPT-2 shape B={b}", q, k, v, do, True)
        for name, e in zip(errs, got):
            errs[name] = max(errs[name], e)
        o, lse = ac.flash_attn_fwd(q, k, v)
        delta = plain.attention_delta(o, do)
        runs = [(*ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta),
                 ac.flash_attn_bwd_dq(q, k, v, do, lse, delta)[0]) for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        log(f"  two backwards at the GPT-2 shape B={b} bit for bit: {same}")
        if not same:
            raise AssertionError(f"two attention backwards on the card differ at B={b}")
        del q, k, v, do, o, lse, delta, runs
        torch.cuda.empty_cache()

    for (b, h, l, d, dtype, causal) in (
        (2, 4, 512, 128, torch.float32, True), (2, 3, 1, 64, torch.float32, True),
        (2, 3, 63, 64, torch.float32, True), (2, 3, 65, 128, torch.float32, True),
        (2, 3, 1000, 64, torch.float32, True), (2, 3, 1000, 64, torch.bfloat16, True),
        (2, 4, 512, 128, torch.bfloat16, False), (2, 3, 300, 64, torch.float32, False),
    ):
        args = _attn_inputs(torch, g, dev, b, h, l, d, dtype)
        _check_attention(torch, f"B={b} H={h} L={l} D={d} {dtype} causal={causal}", *args,
                         causal)
    for dtype in (torch.float32, torch.bfloat16):
        b, h, l, d = 2, 12, 1000, 64
        args = _attn_inputs(torch, g, dev, b, h, l, d, dtype)
        bias = plain.alibi_bias(h, l, l, device=dev)
        _check_attention(torch, f"ALiBi (1, H, L, L) B={b} H={h} L={l} {dtype}", *args, True,
                         bias=bias)
    import numpy as np

    lengths = np.random.default_rng(0).integers(50, 400, 12)
    _, seg, _ = plain.pack_sequences([np.zeros(n) for n in lengths], 1024)
    seg = torch.from_numpy(seg).to(dev)
    args = _attn_inputs(torch, g, dev, seg.shape[0], 4, 1024, 64, torch.float32)
    _check_attention(torch, f"segment ids of {len(lengths)} sequences packed in "
                     f"{seg.shape[0]} rows of 1024", *args, True, seg=seg)

    # The encoders' shapes, non-causal: ViT-B/16's (L = 197, the last 64-row
    # tile 5 rows; bf16, and f32, the dtype its path runs) and BERT-base's
    # (L = 128, segment ids from a padding mask: pads attend only to pads).
    for dtype in (torch.bfloat16, torch.float32):
        _check_attention(torch, f"ViT-B/16 shape B=8 H=12 L={VIT_L} D=64 {dtype} non-causal",
                         *_attn_inputs(torch, g, dev, 8, VIT_HEADS, VIT_L, 64, dtype), False)
    seg = _padding_segments(torch, g, 16, BERT_L, dev)
    _check_attention(torch, f"BERT-base shape B=16 H=12 L={BERT_L} D=64 f32 non-causal, segment "
                     f"ids of rows of {seg.sum(1).tolist()} tokens and their padding",
                     *_attn_inputs(torch, g, dev, 16, ABERT_HEADS, BERT_L, 64, torch.float32),
                     False, seg=seg)

    b, h, l, d = 257, 256, 64, 64
    log(f"flash attention: B={b} H={h} (B*H = {b * h}, past one grid dimension's 65535) "
        f"L={l} D={d} f32 causal, {b * h * l * d * 4 / 2**30:.2f} GiB a tensor")
    _check_attention(torch, f"B*H = {b * h}", *_attn_inputs(torch, g, dev, b, h, l, d,
                                                           torch.float32), True)
    torch.cuda.empty_cache()

    for d in WIDE_HEAD_DIMS:
        log(f"flash attention at head_dim {d} (forward and backward in thread block clusters "
            f"of D / 128 blocks)")
        for (b, h, l, dtype, causal, extra) in (
            (2, 3, 1000, torch.float32, True, None), (2, 3, 257, torch.bfloat16, True, "alibi"),
            (2, 3, 130, torch.float16, False, "segments"), (1, 2, 1, torch.float32, True, None),
            (1, 2, 65, torch.float32, True, None),
        ) + (((2, 3, 300, torch.float32, True, "alibi"),) if d == 640 else ()):
            bias = plain.alibi_bias(h, l, l, device=dev) if extra == "alibi" else None
            seg = None
            if extra == "segments":
                seg = (torch.arange(l, device=dev) * 3 // l).int()[None].repeat(b, 1)
            _check_attention(torch, f"B={b} H={h} L={l} D={d} {dtype} causal={causal} {extra}",
                             *_attn_inputs(torch, g, dev, b, h, l, d, dtype), causal, bias=bias,
                             seg=seg)

    for d in (768, 1024, 2048):
        _check_slices_agree(torch, g, d)
    for d in (256, 640):
        _check_wide_backward_bits(torch, g, d)
    for d in (256, 640, 1024):
        _check_wide_forward_bits(torch, g, d)

    q, k, v = (t.requires_grad_() for t in _attn_inputs(torch, g, dev, 2, 4, 200, 64,
                                                         torch.float32)[:3])
    bias = plain.alibi_bias(4, 200, 200, device=dev).requires_grad_()
    w = torch.randn(q.shape, generator=g).to(dev)
    grads = []
    for fn in (plain.flash_mha, plain.mha_reference):
        (fn(q, k, v, bias=bias) * w).sum().backward()
        grads.append([t.grad.clone() for t in (q, k, v, bias)])
        for t in (q, k, v, bias):
            t.grad = None
    for name, got, ref in zip(("dq", "dk", "dv", "dbias"), *grads):
        compare(f"FlashAttnFunction {name} vs autograd through mha_reference", got, ref,
                attn_tol(ref))
    return errs


def _check_slices_agree(torch, g, d):
    """Up to head_dim 1024 a tile's cluster computes the scores once and
    hands every block, 128 columns each, the same p (and in the forward the
    same rescale factors and row sums); above it every 256-column D slice is
    a block of its own that computes the scores over all of D in the same
    order, and slice 0 alone writes the logsumexp. With q, k, v and do made
    of one 128-column block repeated (256 above 1024), o, dk, dv and dq must
    then be that too, part for part, bit for bit, and o and lse must match
    the plain forward; in f32, bf16 and f16 (B=2, H=3, L=300, causal,
    ALiBi)."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    part = ac.CLUSTER_DIM if d <= ac.MAX_CLUSTERED else ac.SLICE_DIM
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, do = (t.repeat(1, 1, 1, d // part).contiguous()
                       for t in _attn_inputs(torch, g, dev, 2, 3, 300, part, dtype))
        bias = plain.alibi_bias(3, 300, 300, device=dev)
        o, lse = ac.flash_attn_fwd(q, k, v, True, None, bias)
        ro, rlse = plain.flash_attn_fwd_plain(q, k, v, True, None, bias)
        compare(f"flash_attn_fwd head_dim {d} {dtype}, {part}-column parts repeated", o, ro,
                attn_tol(ro))
        compare(f"flash_attn_fwd lse head_dim {d} {dtype}", lse, rlse, f32_tol(rlse))
        delta = plain.attention_delta(o, do)
        dk, dv = ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, True, None, bias)
        dq, _ = ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, True, None, bias, bias_grad=True)
        for name, t in (("o", o), ("dk", dk), ("dv", dv), ("dq", dq)):
            parts = t.split(part, -1)
            if not all(torch.equal(parts[0], x) for x in parts[1:]):
                raise AssertionError(f"head_dim {d} {dtype}: the {part}-column parts of {name} "
                                     f"differ")
        log(f"  head_dim {d} {dtype}: the {d // part} parts of {part} columns of o, dk, dv and "
            f"dq agree bit for bit")


def _check_wide_forward_bits(torch, g, d):
    """Two flash forwards at head_dim d (B=2, H=3, L=300, f32, causal,
    ALiBi) bit for bit, o and lse: the clustered forward sums the slices'
    partial scores in a fixed order, and every output element has one
    writer."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    q, k, v = _attn_inputs(torch, g, dev, 2, 3, 300, d, torch.float32)[:3]
    bias = plain.alibi_bias(3, 300, 300, device=dev)
    runs = [ac.flash_attn_fwd(q, k, v, True, None, bias) for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    log(f"  two forwards at head_dim {d} (o and lse) bit for bit: {same}")
    if not same:
        raise AssertionError(f"two attention forwards on the card differ at head_dim {d}")


def _check_wide_backward_bits(torch, g, d):
    """Two flash backwards at head_dim d (B=2, H=3, L=300, f32, causal,
    ALiBi, with the bias grad) bit for bit: the clustered backward sums the
    slices' partial scores in a fixed order and every output element has one
    writer."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    q, k, v, do = _attn_inputs(torch, g, dev, 2, 3, 300, d, torch.float32)
    bias = plain.alibi_bias(3, 300, 300, device=dev)
    o, lse = ac.flash_attn_fwd(q, k, v, True, None, bias)
    delta = plain.attention_delta(o, do)
    runs = [(*ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, True, None, bias),
             *ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, True, None, bias, bias_grad=True))
            for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    log(f"  two backwards at head_dim {d} (dk, dv, dq and the bias grad) bit for bit: {same}")
    if not same:
        raise AssertionError(f"two attention backwards on the card differ at head_dim {d}")


def _tpu_attention_blockmask(np, l, block):
    """benchmarks/tpu_attention.py's block mask: random 0/1 blocks from seed
    1, the diagonal kept."""
    nb = l // block
    blockmask = np.random.default_rng(1).integers(0, 2, size=(nb, nb))
    blockmask[np.arange(nb), np.arange(nb)] = 1
    return blockmask


def _check_splash(torch, what, q, k, v, do, mask):
    """splash_attn_fwd, splash_attn_bwd_dkv and splash_attn_bwd_dq against
    the plain forward and backward under the mask's dense form; a row that
    sees no key must have lse +inf in both. Returns the three largest errors
    and the kernels' (o, lse, dk, dv, dq)."""
    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    keep = mask.dense(q.device)
    o, lse = ac.splash_attn_fwd(q, k, v, mask)
    ro, rlse = plain.splash_attn_fwd_plain(q, k, v, keep)
    seen = torch.isfinite(rlse)
    if not torch.equal(torch.isfinite(lse), seen):
        raise AssertionError(f"splash_attn_fwd {what}: the rows that see no key differ")
    e_fwd = max(compare(f"splash_attn_fwd {what}", o, ro, attn_tol(ro)),
                compare(f"splash_attn_fwd lse {what}", lse[seen], rlse[seen],
                        f32_tol(rlse[seen])))
    delta = plain.attention_delta(o, do)
    dk, dv = ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask)
    dq = ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask)
    rq, rk, rv = plain.splash_attn_bwd_plain(q, k, v, o, lse, do, keep)
    e_dkv = max(compare(f"splash_attn_bwd_dkv dk {what}", dk, rk, attn_tol(rk)),
                compare(f"splash_attn_bwd_dkv dv {what}", dv, rv, attn_tol(rv)))
    e_dq = compare(f"splash_attn_bwd_dq dq {what}", dq, rq, attn_tol(rq))
    torch.cuda.synchronize()
    return (e_fwd, e_dkv, e_dq), (o, lse, dk, dv, dq)


def _check_splash_kernels(torch, g):
    """The splash kernels at the windowed GPT's shapes (H=12, L=2048, D=64,
    f32, W=256; B=8 as window_train's steps give all three, B=4 as
    window_serve's forwards give the forward), with two backwards bit for
    bit; then W = 1, W = 100 (no multiple of 64), W >= L (which must give
    the causal flash kernels' numbers), ragged L, bf16 and D=128;
    benchmarks/tpu_attention.py's block-sparse case (B=2, H=4, L=1024,
    D=128, bf16, 256-wide blocks, its seed-1 mask with the diagonal kept,
    causal), B*H = 65792 under a window, 16-wide blocks not causal, and a
    mask with an empty row block, which must give exact zeros and finite
    grads."""
    import numpy as np

    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    dev = torch.device("cuda")
    names = ("splash_attn_fwd", "splash_attn_bwd_dkv", "splash_attn_bwd_dq")
    errs = dict.fromkeys(names, 0.0)
    h, l, d = GPT_HEADS, WIN_L_MAX, GPT_HEAD_DIM
    mask = SplashMask.local(l, WIN_W)
    for b, path in ((WIN_TRAIN_B, "window_train"), (WIN_SERVE_B, "window_serve")):
        log(f"splash attention: B={b} H={h} L={l} D={d} f32 window {WIN_W} (the windowed GPT "
            f"shape of {path})")
        q, k, v, do = _attn_inputs(torch, g, dev, b, h, l, d, torch.float32)
        got, (o, lse, dk, dv, dq) = _check_splash(torch, f"windowed GPT shape B={b}", q, k, v,
                                                  do, mask)
        for name, e in zip(names, got):
            errs[name] = max(errs[name], e)
        delta = plain.attention_delta(o, do)
        again = (*ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask),
                 ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask))
        same = all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))
        log(f"  two backwards at the windowed GPT shape B={b} bit for bit: {same}")
        if not same:
            raise AssertionError(f"two splash backwards on the card differ at B={b}")
        del q, k, v, do, o, lse, dk, dv, dq, delta, again
        torch.cuda.empty_cache()

    for (b, hh, ll, dd, dtype, w) in (
        (2, 3, 1000, 64, torch.float32, 1), (2, 3, 1000, 64, torch.float32, 100),
        (2, 3, 65, 64, torch.float32, 30), (2, 3, 1000, 64, torch.bfloat16, 256),
        (2, 4, 512, 128, torch.float32, 200), (2, 4, 512, 128, torch.bfloat16, 64),
    ):
        args = _attn_inputs(torch, g, dev, b, hh, ll, dd, dtype)
        _check_splash(torch, f"B={b} H={hh} L={ll} D={dd} {dtype} window {w}", *args,
                      SplashMask.local(ll, w))
    for (b, hh, ll, dd, dtype) in ((2, 3, 1000, 64, torch.float32),
                                   (2, 4, 65, 128, torch.bfloat16)):
        q, k, v, do = _attn_inputs(torch, g, dev, b, hh, ll, dd, dtype)
        what = f"B={b} H={hh} L={ll} D={dd} {dtype} window {ll + 7} >= L"
        _, got = _check_splash(torch, what, q, k, v, do, SplashMask.local(ll, ll + 7))
        fo, flse = ac.flash_attn_fwd(q, k, v, True)
        delta = plain.attention_delta(fo, do)
        ref = (fo, flse, *ac.flash_attn_bwd_dkv(q, k, v, do, flse, delta, True),
               ac.flash_attn_bwd_dq(q, k, v, do, flse, delta, True)[0])
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        for x, y, name in zip(got, ref, ("o", "lse", "dk", "dv", "dq")):
            compare(f"splash vs causal flash_attn {name} {what}", x, y, attn_tol(y))
        log(f"  {what}: the causal flash kernels' numbers bit for bit: {same}")

    blockmask = _tpu_attention_blockmask(np, 1024, 256)
    log(f"splash attention: benchmarks/tpu_attention.py's block-sparse case, B=2 H=4 L=1024 "
        f"D=128 bf16, 256-wide blocks, causal, mask {blockmask.tolist()}")
    args = _attn_inputs(torch, g, dev, 2, 4, 1024, 128, torch.bfloat16)
    _check_splash(torch, "block-sparse tpu_attention case", *args,
                  SplashMask.blocks(blockmask, 256, causal=True))
    mask16 = np.random.default_rng(2).random((16, 16)) < 0.3
    np.fill_diagonal(mask16, True)
    args = _attn_inputs(torch, g, dev, 2, 3, 256, 64, torch.float32)
    _check_splash(torch, "16-wide blocks, not causal", *args, SplashMask.blocks(mask16, 16))
    for dd in WIDE_HEAD_DIMS:
        log(f"splash attention at head_dim {dd}")
        args = _attn_inputs(torch, g, dev, 2, 3, 1000, dd, torch.float32)
        mask = SplashMask.local(1000, 300)
        _, (o, lse, dk, dv, dq) = _check_splash(torch, f"B=2 H=3 L=1000 D={dd} f32 window 300",
                                                *args, mask)
        if dd in (256, 640):
            delta = plain.attention_delta(o, args[3])
            again = (*ac.splash_attn_bwd_dkv(*args, lse, delta, mask),
                     ac.splash_attn_bwd_dq(*args, lse, delta, mask))
            same = all(torch.equal(x, y) for x, y in zip((dk, dv, dq), again))
            log(f"  two splash backwards at head_dim {dd} bit for bit: {same}")
            if not same:
                raise AssertionError(f"two splash backwards on the card differ at D={dd}")
        args = _attn_inputs(torch, g, dev, 2, 3, 400, dd, torch.bfloat16)
        _check_splash(torch, f"B=2 H=3 L=400 D={dd} bf16 100-wide blocks, causal", *args,
                      SplashMask.blocks(_tpu_attention_blockmask(np, 400, 100), 100, causal=True))
        args = _attn_inputs(torch, g, dev, 2, 3, 129, dd, torch.float16)
        _check_splash(torch, f"B=2 H=3 L=129 D={dd} f16 window 40", *args,
                      SplashMask.local(129, 40))
    b, hh, ll, w = 257, 256, 64, 16
    log(f"splash attention: B={b} H={hh} (B*H = {b * hh}) L={ll} D=64 f32 window {w}")
    _check_splash(torch, f"B*H = {b * hh} window {w}",
                  *_attn_inputs(torch, g, dev, b, hh, ll, 64, torch.float32),
                  SplashMask.local(ll, w))
    torch.cuda.empty_cache()
    empty = np.array([[1, 0, 0, 1], [0, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 1]], bool)
    args = _attn_inputs(torch, g, dev, 2, 3, 400, 64, torch.float32)
    _, (o, lse, dk, dv, dq) = _check_splash(torch, "100-wide blocks, an empty row block",
                                            *args, SplashMask.blocks(empty, 100))
    zero = not o[:, :, 100:200].any() and not dq[:, :, 100:200].any()
    finite = all(bool(torch.isfinite(t).all()) for t in (o, dk, dv, dq))
    log(f"  the empty row block: exact zeros {zero}, every grad finite {finite}")
    if not (zero and finite):
        raise AssertionError("a row block that sees no key must give zeros and finite grads")
    # the same at head_dim 256 and 640: the clustered forward's rows that see
    # no key (o 0, lse +inf)
    for dd in (256, 640):
        args = _attn_inputs(torch, g, dev, 2, 3, 400, dd, torch.float32)
        _, (o, lse, dk, dv, dq) = _check_splash(torch, f"D={dd} 100-wide blocks, an empty row "
                                                f"block", *args, SplashMask.blocks(empty, 100))
        zero = not o[:, :, 100:200].any() and not dq[:, :, 100:200].any()
        inf = bool((lse[:, :, 100:200] == float("inf")).all())
        finite = all(bool(torch.isfinite(t).all()) for t in (o, dk, dv, dq))
        log(f"  the empty row block at head_dim {dd}: exact zeros {zero}, lse +inf {inf}, every "
            f"grad finite {finite}")
        if not (zero and inf and finite):
            raise AssertionError(f"a row block that sees no key must give zeros, lse +inf and "
                                 f"finite grads at head_dim {dd}")
    # a key block that no query sees, at head_dim 256: the dK/dV cluster of its
    # tile walks nothing
    args = _attn_inputs(torch, g, dev, 2, 3, 400, 256, torch.float32)
    _, (o, lse, dk, dv, dq) = _check_splash(torch, "D=256 100-wide blocks, an empty key block",
                                            *args, SplashMask.blocks(empty.T.copy(), 100))
    zero = not dk[:, :, 100:200].any() and not dv[:, :, 100:200].any()
    log(f"  the empty key block at head_dim 256: exact zeros in dk and dv {zero}")
    if not zero:
        raise AssertionError("a key block that no query sees must give zero dk and dv")
    return errs


def _check_operator_spread(torch, runs=12):
    """A small f32 Hyena operator (d_model 64, l_max 512, B=3, L=500) built
    `runs` times from one seed on the card and on the CPU: the spread of the
    card's largest error. Tolerance: 2e-5 of the largest |output| for the
    kernels, plus 16 ulps of the largest in-projection value for the order in
    which cuBLAS adds up the f32 matmuls (the output is 50 times smaller
    than that intermediate)."""
    from flashfftconv_tpu_torch.models.hyena import HyenaOperator

    u = torch.randn(3, 500, 64, generator=torch.Generator().manual_seed(1))
    errs = []
    for _ in range(runs):
        ops = {dev: HyenaOperator(64, 512, conv_dtype=torch.float32, device=dev,
                                  generator=torch.Generator().manual_seed(0))
               for dev in ("cpu", "cuda")}
        with torch.inference_mode():
            ref = ops["cpu"](u)
            errs.append(float((ops["cuda"](u.cuda()).cpu() - ref).abs().max()))
            x_max = float(torch.matmul(ops["cpu"].in_proj, u.transpose(1, 2)).abs().max())
    tol = f32_tol(ref) + 16 * 2.0**-23 * x_max
    log(f"hyena operator, card vs CPU, {runs} runs: max_abs_err min {min(errs):.3e} max "
        f"{max(errs):.3e}, tol={tol:.3e}, |out| <= {float(ref.abs().max()):.3e}, "
        f"|in-projection| <= {x_max:.3e}")
    if not max(errs) <= tol:
        raise AssertionError(f"the operator on the card disagrees with the CPU: {errs}")


def _long_inputs(torch, g, dev):
    """Main-path-shaped inputs of the long kernels, made on the card: the
    taps of one layer and one request of l_max bases' worth of activations."""
    gd = torch.Generator(device=dev).manual_seed(g.initial_seed())
    t = torch.arange(DNA_L_MAX, dtype=torch.float32, device=dev)
    k = torch.randn(DNA_D_MODEL, DNA_L_MAX, generator=gd, device=dev) * 0.02 * torch.exp(-t / 1000)
    u = (torch.randn(1, DNA_D_MODEL, DNA_L_MAX, generator=gd, device=dev) * 0.02).to(torch.bfloat16)
    return k, u


def _check_long(torch, plan, what, u, k, pre=None, post=None):
    """butterfly (both directions), long_conv_inner and long_spectrum against
    their plain versions on the same inputs (long_spectrum and
    long_conv_inner twice, the second long_conv_inner in place, bit for
    bit), and the chain long_conv against the torch.fft oracle. Returns
    {kernel: max abs err}."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    real = torch.view_as_real
    low = u.dtype != torch.float32
    length = u.shape[-1]
    k_f = monarch_cuda.long_spectrum(plan, k)
    ref = real(monarch.long_spectrum_plain(plan, k))
    errs = {"long_spectrum": compare(f"long_spectrum {what}", real(k_f), ref, f32_tol(ref))}
    del ref
    if not torch.equal(real(k_f), real(monarch_cuda.long_spectrum(plan, k))):
        raise AssertionError(f"long_spectrum {what}: two calls differ")
    zr = monarch.butterfly_plain(plan, u, pre)
    z = monarch_cuda.butterfly(plan, u, pre)
    fwd = compare(f"butterfly forward {what}", real(z), real(zr), f32_tol(real(zr)))
    del z
    z2r = monarch.long_conv_inner_plain(plan, zr, k_f)
    z2 = monarch_cuda.long_conv_inner(plan, zr, k_f)
    errs["long_conv"] = compare(f"long_conv_inner {what}", real(z2), real(z2r), f32_tol(real(z2r)))
    if not torch.equal(real(z2), real(monarch_cuda.long_conv_inner(plan, zr, k_f, out=zr))):
        raise AssertionError(f"long_conv_inner {what}: a second call, in place, differs")
    del z2, zr
    yr = monarch.butterfly_inverse_plain(plan, z2r, length, post, u.dtype)
    y = monarch_cuda.butterfly(plan, z2r, post, inverse=True, length=length, dtype=u.dtype)
    inv = compare(f"butterfly inverse {what}", y, yr, lowp_tol(yr) if low else f32_tol(yr))
    errs["butterfly"] = max(fwd, inv)
    del y, yr, z2r
    ref = monarch.fft_conv_reference(plan.seqlen, u, k, pre, post)
    compare(f"long_conv vs torch.fft {what}", monarch_cuda.long_conv(plan, u, k_f, pre, post),
            ref, lowp_tol(ref) if low else f32_tol(ref))
    torch.cuda.synchronize()
    return errs


def _check_long_bwd(torch, plan, what, u, k, pre, post, g):
    """long_conv_bwd_inner and long_dk_finish against their plain versions on
    the same bands and partials, the whole long backward (long_conv_bwd, then
    long_dk_finish) against conv_bwd_plain and dk_finish_plain, and a second
    run of the whole backward against the first, bit for bit. Returns
    {kernel: max abs err}."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    real = torch.view_as_real
    low = u.dtype != torch.float32
    gated = pre is not None
    dout = torch.randn(u.shape, generator=g).to(u.device, u.dtype)
    k_len = k.shape[-1]
    k_f = monarch_cuda.long_spectrum(plan, k)
    zu = monarch.butterfly_plain(plan, u, pre)
    zg = monarch.butterfly_plain(plan, dout.float() * post.float() if gated else dout)
    got = monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f, need_y=gated)
    ref = monarch.long_conv_bwd_inner_plain(plan, zu, zg, k_f, need_y=gated)
    del zu, zg
    err = 0.0
    for name, a, r in zip(("du bands", "y bands", "partials"), got, ref):
        if r is not None:
            err = max(err, compare(f"long_conv_bwd_inner {what}: {name}", real(a), real(r),
                                   f32_tol(real(r))))
    partials = ref[2]
    del got, ref
    dk_ref = monarch.long_dk_finish_plain(plan, partials, k_len)
    dk = monarch_cuda.long_dk_finish(plan, partials, k_len)
    errs = {"long_conv_bwd": err,
            "long_dk_finish": compare(f"long_dk_finish {what}: dk", dk, dk_ref, f32_tol(dk_ref))}
    if not torch.equal(dk, monarch_cuda.long_dk_finish(plan, partials, k_len)):
        raise AssertionError(f"long_dk_finish {what}: two calls differ")
    del partials, dk_ref, dk

    def whole():
        du, dpre, dpost, parts = monarch_cuda.long_conv_bwd(plan, u, k_f, pre, post, dout)
        return du, dpre, dpost, monarch_cuda.long_dk_finish(plan, parts, k_len)

    first = whole()
    ref = monarch.conv_bwd_plain(plan, u, k_f, pre, post, dout)
    ref = (*ref[:3], monarch.dk_finish_plain(plan, ref[3], k_len))
    for name, a, r in zip(("du", "dpre", "dpost", "dk"), first, ref):
        if r is not None:
            f32 = name == "dk" or not low
            compare(f"long backward vs conv_bwd_plain {what}: {name}", a, r,
                    f32_tol(r) if f32 else lowp_tol(r))
    del ref
    for name, a, r in zip(("du", "dpre", "dpost", "dk"), first, whole()):
        if a is not None and not torch.equal(a, r):
            raise AssertionError(f"long backward {what}: two runs differ in {name}")
    torch.cuda.synchronize()
    return errs


def _check_long_kernels(torch, g):
    """The long kernels, forward and backward, at the dna path's shapes, then
    at every listed FFT size in f32 and bf16: B = 1 ungated at L = N/2, B = 3
    and 4 gated at ragged lengths and channel counts; long_spectrum on two
    plans of an 8192-point band; and the short depthwise conv at 1,048,576
    positions."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(DNA_N_FFT, torch.bfloat16, device=dev)
    k, u = _long_inputs(torch, g, dev)
    log(f"long kernels: B=1 H={DNA_D_MODEL} L={DNA_L_MAX} N={DNA_N_FFT} bf16 ungated, "
        f"factors={plan.factors} (outer {plan.outer}, band {plan.band})")
    errs = _check_long(torch, plan, "main path", u, k)
    errs.update(_check_long_bwd(torch, plan, "main path", u, k, None, None, g))
    del k, u, plan
    for n in LONG_SIZES:
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, length, gated in ((1, 3, n // 2, False), (3, 2, n // 2 + 3, True),
                                        (4, 2, n - 5, True)):
                uu, pre, post = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                                 for _ in "abc")
                kk = (torch.randn(h, n // 2 - 1, generator=g) * 0.05).to(dev)
                gates = (pre, post) if gated else (None, None)
                what = (f"N={n} B={b} H={h} L={length} {'gated' if gated else 'ungated'} "
                        f"{dtype}")
                _check_long(torch, p, what, uu, kk, *gates)
                _check_long_bwd(torch, p, what, uu, kk, *gates, g)
        del p
    # long_spectrum on plans of an 8192-point band (132 KB of shared memory a
    # block): F = 8 and F = 128.
    for n, factors in ((131072, (8, 32, 16, 16)), (DNA_N_FFT, (16, 8, 32, 16, 16))):
        p = make_plan(n, torch.float32, device=dev, factors=factors)
        kk = (torch.randn(3, n // 2 - 1, generator=g) * 0.05).to(dev)
        what = f"N={n} F={p.outer} R={p.band}"
        k_f = monarch_cuda.long_spectrum(p, kk)
        ref = torch.view_as_real(monarch.long_spectrum_plain(p, kk))
        compare(f"long_spectrum {what}", torch.view_as_real(k_f), ref, f32_tol(ref))
        if not torch.equal(k_f, monarch_cuda.long_spectrum(p, kk)):
            raise AssertionError(f"long_spectrum {what}: two calls differ")
        del p, k_f, ref
    d = 3 * DNA_D_MODEL
    log(f"depthwise: B=1 D={d} L={DNA_L_MAX} K=3 padding=(2, 0) bias bf16 BHL")
    x = torch.randn(1, d, DNA_L_MAX, generator=g).to(dev, torch.bfloat16)
    w = (torch.rand(d, 3, generator=g) * 2 / math.sqrt(d)).to(dev)
    bias = (torch.randn(d, generator=g) * 0.1).to(dev)
    ref = dw.depthwise_plain(x, w, bias, (2, 0), True)
    compare("depthwise at the dna path's shape", dw.depthwise(x, w, bias, (2, 0), True), ref,
            lowp_tol(ref))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


def _check_band_kernels(torch, g):
    """band_conv, both conj, against band_conv_plain on complex bands with a
    nonzero imaginary part: at the seq_train path's shape (B=4, H=768,
    N2=16384) and at every N2 = 16 ... 16384 (one instance each) with B = 3,
    so that a channel's rows run in a ragged group of the channel-major block
    order, H = 7, two calls bit for bit; the four-real-conv route of bands
    from 32768 up (monarch_conv, then the long kernels) against
    band_conv_plain at N2 = 32768 and 131072; and the sequence-parallel conv
    at world size 1, gated and padded, output and grads against the
    torch.fft oracle's autograd. Tolerance band_tol. Returns {"band_conv":
    its largest error at the main shape}."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan
    from flashfftconv_tpu_torch.parallel import seq_conv

    dev = torch.device("cuda")
    real = torch.view_as_real
    gd = torch.Generator(device=dev).manual_seed(g.initial_seed())
    cplx = lambda *shape: torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gd)
    err = 0.0
    for b, h, n2 in ((B, D_MODEL, SEQ_N2), *((3, 7, 16 << i) for i in range(11))):
        plan = make_plan(2 * n2, torch.float32, device=dev)
        x, k_f = cplx(b, h, n2), cplx(h, n2)
        for conj in (False, True):
            ref = monarch.band_conv_plain(plan, x, k_f, conj)
            y = monarch_cuda.band_conv(plan, x, k_f, conj)
            e = compare(f"band_conv B={b} H={h} N2={n2} conj={conj}", real(y), real(ref),
                        band_tol(ref))
            if not torch.equal(y, monarch_cuda.band_conv(plan, x, k_f, conj)):
                raise AssertionError(f"band_conv B={b} H={h} N2={n2} conj={conj}: two calls "
                                     f"differ")
            err = max(err, e) if b == B else err
        del x, k_f, ref
        torch.cuda.synchronize()
    for n2 in (32768, 131072):
        plan = make_plan(2 * n2, torch.float32, device=dev)
        x, kt = cplx(2, 3, n2), cplx(3, n2) * 0.01
        ref = monarch.band_conv_plain(plan, x, monarch.cfft_plain(plan, kt))
        compare(f"band conv N2={n2} as four real convs", real(seq_conv._band_conv_composed(x, kt)),
                real(ref), band_tol(ref))
        torch.cuda.synchronize()
    mesh = _seq_mesh(torch)
    n = SEQ_N2
    t = torch.arange(n, device=dev)
    u, pre, post = (torch.randn(2, 16, n, device=dev, generator=gd) for _ in "abc")
    k = torch.randn(16, n, device=dev, generator=gd) * 0.02 * torch.exp(-t / 1000)
    ref = monarch.fft_conv_reference(n, u, k, pre, post)
    compare(f"seq_fft_conv gated world 1 N={n} vs torch.fft",
            seq_conv.seq_fft_conv(u, k, mesh, pregate=pre, postgate=post), ref, band_tol(ref))
    u, k = u[..., : n // 2].clone().requires_grad_(), k[:, : n // 2].clone().requires_grad_()
    y = seq_conv.seq_fft_conv_padded(u, k, mesh)
    ref = monarch.fft_conv_reference(n, u, k)
    compare(f"seq_fft_conv_padded world 1 N={n} L={n // 2} vs torch.fft", y, ref, band_tol(ref))
    dy = torch.randn(y.shape, device=dev, generator=gd)
    for name, a, r in zip(("du", "dk"), torch.autograd.grad(y, (u, k), dy),
                          torch.autograd.grad(ref, (u, k), dy)):
        compare(f"seq_fft_conv_padded world 1 grads: {name}", a, r, band_tol(r))
    torch.cuda.synchronize()
    return {"band_conv": err}


def _check_direct(torch, plan, what, u, k, pre, post, dout):
    """spectrum, direct_conv, direct_conv_bwd and dk_finish against their
    plain versions on the same inputs (the backward's is conv_bwd_plain, the
    row-FFT backward's, its dk partials grouped by bwd_group(B)), and a
    second forward and backward against the first, bit for bit. Returns
    (direct_conv error, direct_conv_bwd error)."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    real = torch.view_as_real
    low = u.dtype != torch.float32
    k_len = k.shape[-1]
    k_f = monarch_cuda.spectrum(plan, k)
    ref = real(monarch.kernel_spectrum(plan, k))
    compare(f"spectrum {what}", real(k_f), ref, f32_tol(ref))
    ref = monarch.direct_conv_plain(plan, u, k_f, pre, post)
    y = monarch_cuda.direct_conv(plan, u, k_f, pre, post)
    fwd = compare(f"direct_conv {what}", y, ref, lowp_tol(ref) if low else f32_tol(ref))
    if not torch.equal(y, monarch_cuda.direct_conv(plan, u, k_f, pre, post)):
        raise AssertionError(f"direct_conv {what}: two calls differ")
    got = monarch_cuda.direct_conv_bwd(plan, u, k_f, pre, post, dout)
    ref = monarch.conv_bwd_plain(plan, u, k_f, pre, post, dout)
    if got[3].shape != ref[3].shape:
        raise AssertionError(f"direct_conv_bwd {what}: partials shape {tuple(got[3].shape)} != "
                             f"{tuple(ref[3].shape)}")
    bwd = 0.0
    for name, a, r in zip(("du", "dpre", "dpost"), got[:3], ref[:3]):
        if r is not None:
            bwd = max(bwd, compare(f"direct_conv_bwd {what}: {name}", a, r,
                                   lowp_tol(r) if low else f32_tol(r)))
    pr = real(ref[3])
    bwd = max(bwd, compare(f"direct_conv_bwd {what}: dk partials", real(got[3]), pr,
                           f32_tol(pr)))
    dk = monarch_cuda.dk_finish(plan, got[3], k_len)
    dk_ref = monarch.dk_finish_plain(plan, ref[3], k_len)
    compare(f"dk_finish {what}: dk", dk, dk_ref, f32_tol(dk_ref))
    again = monarch_cuda.direct_conv_bwd(plan, u, k_f, pre, post, dout)
    for name, a, r in zip(("du", "dpre", "dpost", "dk spectrum"), got, again):
        if a is not None and not torch.equal(a, r):
            raise AssertionError(f"direct_conv_bwd {what}: two runs differ in {name}")
    if not torch.equal(dk, monarch_cuda.dk_finish(plan, again[3], k_len)):
        raise AssertionError(f"dk_finish {what}: two runs differ")
    torch.cuda.synchronize()
    return fwd, bwd


def _check_direct_kernels(torch, g):
    """The direct kernels at the M2-BERT path's shape (B=128, H=768, L=128,
    N=256, bf16, ungated; 16 dk partials), then at every FFT size from 16 to
    512 in f32 and bf16: gated and ungated, L = N/2 + 3, N/2 and N, B = 1, 3,
    20 (five groups of four rows) and
    130 (two row blocks of the forward; 65 groups of two rows), H = 7, 3 and
    5."""
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(BERT_N_FFT, torch.bfloat16, device=dev)
    t = torch.arange(BERT_N_FFT, dtype=torch.float32)
    k = (torch.randn(BERT_D_MODEL, BERT_N_FFT, generator=g) * 0.02 * torch.exp(-t / 50)).to(dev)
    u, dout = ((torch.randn(BERT_B, BERT_D_MODEL, BERT_L, generator=g) * 0.02)
               .to(dev, torch.bfloat16) for _ in "ab")
    log(f"direct kernels: B={BERT_B} H={BERT_D_MODEL} L={BERT_L} N={BERT_N_FFT} bf16 ungated, "
        f"k_len={BERT_N_FFT} (a bidirectional kernel), spectrum factors {plan.factors}")
    fwd, bwd = _check_direct(torch, plan, "main path", u, k, None, None, dout)
    errs = {"direct_conv": fwd, "direct_conv_bwd": bwd}
    for n in DIRECT_SIZES:
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, length, gated in ((1, 7, n // 2 + 3, True), (3, 7, n, False),
                                        (20, 3, n, True), (130, 5, n // 2, False)):
                uu, pre, post, dd = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                                     for _ in "abcd")
                kk = (torch.randn(h, n, generator=g) * 0.1).to(dev)
                gates = (pre, post) if gated else (None, None)
                what = (f"N={n} B={b} H={h} L={length} {'gated' if gated else 'ungated'} "
                        f"{dtype}")
                _check_direct(torch, p, what, uu, kk, *gates, dd)
    return errs


def _check_conv_bwd(torch, plan, what, u, k_f, pre, post, dout, k_len):
    """monarch_conv_bwd and dk_finish against conv_bwd_plain and
    dk_finish_plain, the partials against the plain version's, grouped as
    the kernel groups them (B / bwd_group(B), H, M+1); two calls give the
    same bits. Returns (du error, dk error)."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    got = monarch_cuda.monarch_conv_bwd(plan, u, k_f, pre, post, dout)
    again = monarch_cuda.monarch_conv_bwd(plan, u, k_f, pre, post, dout)
    if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"monarch_conv_bwd {what}: two calls differ")
    ref = monarch.conv_bwd_plain(plan, u, k_f, pre, post, dout)
    low = u.dtype != torch.float32
    errs = []
    for name, a, r in zip(("du", "dpre", "dpost"), got[:3], ref[:3]):
        if r is not None:
            errs.append(compare(f"monarch_conv_bwd {what}: {name}", a, r,
                                lowp_tol(r) if low else f32_tol(r)))
    pr = torch.view_as_real(ref[3])
    compare(f"monarch_conv_bwd {what}: partials", torch.view_as_real(got[3]), pr, f32_tol(pr))
    dk_ref = monarch.dk_finish_plain(plan, ref[3], k_len)
    dk_err = compare(f"dk_finish {what}: dk", monarch_cuda.dk_finish(plan, got[3], k_len),
                     dk_ref, f32_tol(dk_ref))
    torch.cuda.synchronize()
    return errs[0], dk_err


def _check_dw_bwd(torch, what, x, w, dout, pad, is_bhl):
    """depthwise_bwd against depthwise_bwd_plain; dk and dbias are sums over
    B*L and are held to sum_tol of the terms' magnitudes. Returns du's error."""
    from flashfftconv_tpu_torch.ops import depthwise as dw

    du, dk, db = dw.depthwise_bwd(x, w, dout, pad, is_bhl)
    rdu, rdk, rdb = dw.depthwise_bwd_plain(x, w, dout, pad, is_bhl)
    _, adk, adb = dw.depthwise_bwd_plain(x.abs(), w, dout.abs(), pad, is_bhl)
    err = compare(f"depthwise_bwd {what}: du", du, rdu,
                  f32_tol(rdu) if x.dtype == torch.float32 else lowp_tol(rdu))
    compare(f"depthwise_bwd {what}: dk", dk, rdk, sum_tol(adk))
    compare(f"depthwise_bwd {what}: dbias", db, rdb, sum_tol(adb))
    again = dw.depthwise_bwd(x, w, dout, pad, is_bhl)
    if not all(torch.equal(a, b) for a, b in zip((du, dk, db), again)):
        raise AssertionError(f"depthwise_bwd {what}: two calls differ")
    torch.cuda.synchronize()
    return err


def _poison(torch, like):
    """Free a NaN-filled block of like's size, which the caching allocator
    hands to the next allocation of that size: an output the kernel leaves
    partly unwritten then shows as NaN, not as an older result's values."""
    torch.full_like(like, math.nan)


def _check_dw_shapes(torch, g):
    """Both depthwise kernels against their plain versions at M2-BERT's
    shape (B=128, D=2304, L=128, padding 1) and HyenaDNA's (B=1, D=768,
    L=1,048,576, causal), and at ragged ones: L=100 (bf16 rows 200 bytes
    apart, off 16 bytes) and odd L, K=5 and 7, out_len != L, BLH, f32, bf16
    and f16, an input one element off a 16-byte boundary; the backward
    twice, bit for bit (_check_dw_bwd)."""
    from flashfftconv_tpu_torch.ops import depthwise as dw

    dev = torch.device("cuda")
    for (b, d, length), k, pad, is_bhl, dtype, skew in (
        ((BERT_B, 3 * BERT_D_MODEL, BERT_L), 3, (1, 1), True, torch.bfloat16, 0),
        ((1, 3 * DNA_D_MODEL, DNA_L_MAX), 3, (2, 0), True, torch.bfloat16, 0),
        ((8, 3 * BERT_D_MODEL, 100), 3, (1, 1), True, torch.bfloat16, 0),
        ((1, 3 * BERT_D_MODEL, 100), 3, (1, 1), True, torch.bfloat16, 0),
        ((3, 37, 4097), 3, (2, 0), True, torch.float16, 0),
        ((5, 64, 1024), 5, (2, 2), True, torch.float16, 0),
        ((5, 64, 1024), 7, (6, 0), True, torch.float32, 0),
        ((4, 300, 512), 7, (3, 3), True, torch.bfloat16, 1),
        ((3, 37, 1031), 5, (1, 3), True, torch.bfloat16, 0),
        ((2, 300, 1000), 7, (0, 9), False, torch.bfloat16, 0),
        ((2, 64, 256), 9, (4, 4), True, torch.float32, 0),
    ):
        xs = (b, d, length) if is_bhl else (b, length, d)
        n = b * d * length
        x = torch.randn(n + skew, generator=g).to(dev, dtype)[skew:].view(xs)
        w = (torch.randn((d, k) if is_bhl else (k, d), generator=g) * 0.3).to(dev)
        bias = torch.randn(d, generator=g).to(dev)
        out_len = length + sum(pad) - k + 1
        what = (f"{'BHL' if is_bhl else 'BLH'} B={b} D={d} L={length} K={k} padding={pad} "
                f"{dtype}{' off 16 bytes' if skew else ''}")
        ref = dw.depthwise_plain(x, w, bias, pad, is_bhl)
        _poison(torch, ref)
        compare(f"depthwise {what}", dw.depthwise(x, w, bias, pad, is_bhl), ref,
                f32_tol(ref) if dtype == torch.float32 else lowp_tol(ref))
        del ref
        dd = torch.randn(b * d * out_len + skew, generator=g).to(dev, dtype)[skew:].view(
            (b, d, out_len) if is_bhl else (b, out_len, d))
        _poison(torch, x)
        _check_dw_bwd(torch, what, x, w, dd, pad, is_bhl)
        del x, dd
        torch.cuda.empty_cache()


def _counters(names=("spectrum", "monarch_conv", "depthwise")):
    """The kernel wrappers of the given names, each with its launches count."""
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops import monarch_cuda
    from flashfftconv_tpu_torch.utils import smem_probe as sp

    wrappers = {"spectrum": monarch_cuda.spectrum, "monarch_conv": monarch_cuda.monarch_conv,
                "monarch_conv_bwd": monarch_cuda.monarch_conv_bwd,
                "dk_finish": monarch_cuda.dk_finish, "depthwise": dw.depthwise,
                "depthwise_bwd": dw.depthwise_bwd, "butterfly": monarch_cuda.butterfly,
                "long_conv": monarch_cuda.long_conv_inner,
                "long_spectrum": monarch_cuda.long_spectrum,
                "long_conv_bwd": monarch_cuda.long_conv_bwd_inner,
                "long_dk_finish": monarch_cuda.long_dk_finish,
                "direct_conv": monarch_cuda.direct_conv,
                "direct_conv_bwd": monarch_cuda.direct_conv_bwd,
                "band_conv": monarch_cuda.band_conv,
                "flash_attn_fwd": ac.flash_attn_fwd,
                "flash_attn_bwd_dkv": ac.flash_attn_bwd_dkv,
                "flash_attn_bwd_dq": ac.flash_attn_bwd_dq,
                "splash_attn_fwd": ac.splash_attn_fwd,
                "splash_attn_bwd_dkv": ac.splash_attn_bwd_dkv,
                "splash_attn_bwd_dq": ac.splash_attn_bwd_dq,
                "smem_probe_touch": sp.smem_probe_touch, "smem_copy": sp.smem_copy}
    return {name: wrappers[name] for name in names}


def _hyena_125m(torch, seed, dev, mixer_kwargs=None, dtype=None, mixer="hyena", **kw):
    """The hyena-125M preset's LM (mixer="h3": H3-125M); ``kw`` go to the
    model (``moe_kwargs``)."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

    return ConvLMHeadModel(
        d_model=D_MODEL, n_layer=N_LAYER, d_inner=4 * D_MODEL, vocab_size=VOCAB, l_max=L_MAX,
        mixer=mixer, mixer_kwargs=mixer_kwargs, dtype=dtype or torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(seed), **kw,
    )


def _corpus(np):
    """Byte ids of the JAX package's Python sources, the corpus that
    examples/lm/train.py reads by default (flashfftconv_tpu/**/*.py; ids <
    256; the head stays sized at the GPT-2 vocab). The port's sources are
    not in it, so an edit of the port leaves every phase's data as it was."""
    paths = sorted(HERE.glob("flashfftconv_tpu/**/*.py"))
    data = np.concatenate([np.frombuffer(p.read_bytes(), np.uint8) for p in paths])
    if data.size < B * (L_MAX + 1):
        raise AssertionError(f"corpus of {data.size} bytes is too small")
    return data.astype(np.int64)


def _train_batches(torch, np, seed, dev, n_steps, b=B, length=L_MAX):
    """n_steps (x, y) batches of b windows of length + 1 bytes of the corpus."""
    tokens = _corpus(np)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_steps):
        offs = rng.integers(0, tokens.size - length - 1, b)
        xy = torch.from_numpy(np.stack([tokens[o : o + length + 1] for o in offs])).to(dev)
        batches.append((xy[:, :-1].contiguous(), xy[:, 1:].contiguous()))
    return batches


def phase_train(torch, seed, np):
    """Hyena-125M (12 layers, d_model 768, l_max 8192, B=4, bf16 activations,
    f32 master weights, dropout on) takes TRAIN_WARMUP + TRAIN_TIMED steps of
    the examples/lm recipe on byte data."""
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    dev = torch.device("cuda")
    torch.manual_seed(seed)  # the dropout masks repeat from run to run
    model = _hyena_125m(torch, seed, dev).train()
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=n_steps)
    step = make_train_step(model, opt, sched, clip=1.0)
    batches = _train_batches(torch, np, seed, dev, n_steps)
    counters = _counters(TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, per_step = [], [], []
    try:
        for x, y in batches:
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(x, y)
            loss = float(out["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(f"Hyena-125M train step ran out of memory: peak "
                             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB") from e
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {TRAIN_LAUNCHES}")
    timed = step_ms[TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {
        "steps": n_steps,
        "losses": losses,
        "step_ms": step_ms,
        "step_ms_median": med,
        "step_ms_max": max(timed),
        "tokens_per_s": B * L_MAX / (med / 1e3),
        "launches": launches,
        "peak_memory_bytes": peak,
    }
    log(f"train: Hyena-125M B={B} L={L_MAX} bf16, {n_steps} steps (lr 3e-4, wd 0.1, clip 1.0, "
        f"warmup 2), losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"train: step median {med:.2f} ms max {max(timed):.2f} ms over {TRAIN_TIMED} timed "
        f"steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    return res


_MESH = {}


def _seq_mesh(torch):
    """A 1-rank sequence mesh on the card: NCCL over an in-memory store (no
    network), the "sp" dimension of a DeviceMesh, made once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if "sp" not in _MESH:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        _MESH["sp"] = init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
    return _MESH["sp"]


def _worst_rel(grads, ref) -> tuple[float, str]:
    """(max |grad - ref| / max |ref|, parameter) over every parameter."""
    return max((float((g - ref[n]).abs().max() / ref[n].abs().max().clamp(min=1e-12)), n)
               for n, g in grads.items())


def _noise_grad_check(grads, ref, noise):
    """Each parameter's grads against the reference's, held at 1e-3 of the
    largest |ref| plus twice ``noise``, the parameter's max |grad - ref| of
    a control: the same bf16 model whose long convs take another f32 route.
    A bf16 model rounds each conv's f32 output to bf16, so two f32 routes
    whose outputs differ by roundoff flip some of those roundings by one
    ulp, and the grads downstream differ by that noise, not by a share of
    the largest |grad| (up to 2^-7 of it where a grad is itself a bf16
    product). Returns {"worst": (max |d| / tol, parameter), "worst_rel":
    (max |d| / max |ref|, parameter), "worst_vs_control": (max |d| / noise,
    parameter)}; the check holds if "worst" is at most 1."""
    worst, rel, vs = (0.0, ""), (0.0, ""), (0.0, "")
    for n, g in grads.items():
        d = float((g.float() - ref[n].float()).abs().max())
        scale = float(ref[n].abs().max())
        worst = max(worst, (d / max(1e-3 * scale + 2 * noise[n], 1e-30), n))
        rel = max(rel, (d / max(scale, 1e-30), n))
        vs = max(vs, (d / max(noise[n], 1e-30), n))
    return {"worst": worst, "worst_rel": rel, "worst_vs_control": vs}


def _seq_route_f32(torch, seed, dev, mesh, x, y):
    """Hyena-125M at full width in f32 activations, dropout on, on the batch
    (x, y): loss and grads of one backward through the 1-rank seq mesh
    (seq_backward, as make_train_step runs it) against the plain model's,
    on the same dropout mask. Returns (loss relative error, (worst grad
    relative error, parameter), peak bytes)."""
    from flashfftconv_tpu_torch.parallel.seq_conv import seq_backward, seq_group
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    out = []
    torch.cuda.reset_peak_memory_stats()
    for kw in (None, {"seq_mesh": mesh, "seq_axis": "sp"}):
        model = _hyena_125m(torch, seed, dev, kw, dtype=torch.float32).train()
        torch.manual_seed(seed)
        loss = cross_entropy(model(x), y)
        if kw is None:
            loss.backward()
        else:
            loss = seq_backward(model, loss, y.numel(), seq_group(model))
        out.append((float(loss), {n: p.grad for n, p in model.named_parameters()}))
        del model, loss
        torch.cuda.empty_cache()
    (ref_loss, ref), (loss, grads) = out
    return (abs(loss - ref_loss) / abs(ref_loss), _worst_rel(grads, ref),
            torch.cuda.max_memory_allocated())


def phase_seq_train(torch, seed, np):
    """Hyena-125M with every long conv sequence-parallel over a 1-rank mesh
    (the band_conv route at N2 = 16384) against the plain model. In f32
    activations, on the first batch (B=4) and dropout mask: loss within 1e-3
    relative and grads within 1e-3 of each parameter's largest |grad|. Then
    the bf16 model takes SEQ_WARMUP + SEQ_TIMED steps of the train phase's
    recipe, schedule and batches; its first step's loss (1e-3 relative) and
    grads (before the clip) against the plain bf16 model's on the same
    batch, weights and dropout mask, by ``_noise_grad_check``: bf16
    rounding noise moves them by more than a 1e-3 share (up to 7e-3 of the
    largest |grad| in a Dense weight grad), and a control of the plain
    model with its long convs through torch.fft measures that noise."""
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    dev = torch.device("cuda")
    mesh = _seq_mesh(torch)
    n_steps = SEQ_WARMUP + SEQ_TIMED
    batches = _train_batches(torch, np, seed, dev, TRAIN_WARMUP + TRAIN_TIMED)[:n_steps]
    x0, y0 = batches[0]
    torch.cuda.empty_cache()
    f32_loss_err, f32_grad_err, f32_peak = _seq_route_f32(torch, seed, dev, mesh, x0, y0)
    log(f"seq_train: f32, B={B}, dropout on, seq route vs plain model: loss rel err "
        f"{f32_loss_err:.3e} (tol 1e-3), max |dgrad| / max |grad| {f32_grad_err[0]:.3e} "
        f"({f32_grad_err[1]}), tol 1e-3; peak memory {f32_peak / 2**30:.2f} GiB")
    if not (f32_loss_err <= 1e-3 and f32_grad_err[0] <= 1e-3):
        raise AssertionError(f"f32 seq route disagrees: {f32_loss_err}, {f32_grad_err}")
    ref = _hyena_125m(torch, seed, dev).train()
    torch.manual_seed(seed)
    ref_loss = cross_entropy(ref(x0), y0)
    ref_loss.backward()
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    ref_loss = float(ref_loss)
    del ref
    ctl = _hyena_125m(torch, seed, dev, mixer_kwargs={"impl": "fft"}).train()
    torch.manual_seed(seed)
    ctl_loss = cross_entropy(ctl(x0), y0)
    ctl_loss.backward()
    noise = {n: float((p.grad - ref_grads[n]).abs().max()) for n, p in ctl.named_parameters()}
    ctl_loss = float(ctl_loss)
    del ctl
    torch.cuda.empty_cache()

    model = _hyena_125m(torch, seed, dev, mixer_kwargs={"seq_mesh": mesh, "seq_axis": "sp"})
    model.train()
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2,
                              steps=TRAIN_WARMUP + TRAIN_TIMED)
    step = make_train_step(model, opt, sched, clip=1.0)
    counters = _counters(SEQ_TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    torch.manual_seed(seed)
    losses, step_ms, per_step, grad_err = [], [], [], None
    try:
        for i, (x, y) in enumerate(batches):
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(x, y)
            loss = float(out["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
            if i == 0:  # undo the clip: grad * min(1, 1 / (norm + 1e-6))
                unclip = max(1.0, float(out["grad_norm"]) + 1e-6)
                grad_err = _noise_grad_check(
                    {n: p.grad * unclip for n, p in model.named_parameters()}, ref_grads, noise)
                del ref_grads
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(f"sequence-parallel Hyena-125M train step ran out of memory: peak "
                             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB") from e
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    loss_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    log(f"seq_train: first step against the plain model: loss {losses[0]:.6f} vs {ref_loss:.6f} "
        f"(rel err {loss_err:.3e}, tol 1e-3; the torch.fft control {ctl_loss:.6f}); grads: worst "
        f"max |dgrad| / (1e-3 max |grad| + 2 control) {grad_err['worst'][0]:.3f} "
        f"({grad_err['worst'][1]}, tol 1), max |dgrad| / max |grad| "
        f"{grad_err['worst_rel'][0]:.3e} ({grad_err['worst_rel'][1]}), max |dgrad| / control "
        f"{grad_err['worst_vs_control'][0]:.3f} ({grad_err['worst_vs_control'][1]})")
    if not loss_err <= 1e-3:
        raise AssertionError(f"seq_train first loss {losses[0]} != plain {ref_loss}")
    if not grad_err["worst"][0] <= 1.0:
        raise AssertionError(f"seq_train grads disagree with the plain model's: {grad_err}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != SEQ_TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {SEQ_TRAIN_LAUNCHES}")
    timed = step_ms[SEQ_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "world_size": 1, "band": SEQ_N2, "losses": losses,
           "step_ms": step_ms, "step_ms_median": med, "step_ms_max": max(timed),
           "tokens_per_s": B * L_MAX / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak, "f32_loss_rel_err": f32_loss_err,
           "f32_grad_max_rel_err": f32_grad_err[0], "f32_grad_worst_param": f32_grad_err[1],
           "f32_peak_memory_bytes": f32_peak, "first_loss_rel_err": loss_err,
           "control_loss": ctl_loss, "first_grad_check": grad_err}
    log(f"seq_train: Hyena-125M B={B} L={L_MAX} bf16 on a 1-rank seq mesh (N2={SEQ_N2}), "
        f"{n_steps} steps, losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"seq_train: step median {med:.2f} ms max {max(timed):.2f} ms over {SEQ_TIMED} timed "
        f"steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    del model, step, opt
    torch.cuda.empty_cache()
    return res


def phase_grad_parity(torch, seed):
    """The 2-layer f32 LM of phase_parity with the same weights on the card
    (backward kernels) and on the CPU (plain backward): every parameter's
    grad, and the loss after one AdamW step."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    kw = dict(d_model=128, n_layer=2, d_inner=512, vocab_size=256, l_max=1024,
              mixer_kwargs={"conv_dtype": torch.float32}, dtype=torch.float32)
    ids = torch.randint(0, 256, (2, 1025), generator=torch.Generator().manual_seed(seed + 2))
    grads, losses = {}, {}
    bwd0 = _counters(("monarch_conv_bwd", "depthwise_bwd"))
    before = {name: fn.launches for name, fn in bwd0.items()}
    for dev in ("cpu", "cuda"):
        model = ConvLMHeadModel(**kw, device=dev,
                                generator=torch.Generator().manual_seed(seed)).eval()
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        loss = cross_entropy(model(x), y)
        loss.backward()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.1)
        opt.step()
        with torch.no_grad():
            losses[dev] = (float(loss), float(cross_entropy(model(x), y)))
    for name, fn in bwd0.items():
        if fn.launches - before[name] != 2:
            raise AssertionError(f"{name} launched {fn.launches - before[name]} times, expected 2")
    worst = max(((g - grads["cpu"][n]).abs().max() / grads["cpu"][n].abs().max().clamp(min=1e-12),
                 n) for n, g in grads["cuda"].items())
    ratio, worst_name = float(worst[0]), worst[1]
    step_err = abs(losses["cuda"][1] - losses["cpu"][1]) / abs(losses["cpu"][1])
    log(f"grad_parity: 2-layer f32 LM, card (kernels) vs CPU (plain) over {len(grads['cpu'])} "
        f"params: max |dgrad| / max |grad| = {ratio:.3e} ({worst_name}), tol 1e-3; losses "
        f"{losses['cuda']} vs {losses['cpu']}, after one AdamW step rel err {step_err:.3e}, "
        f"tol 1e-4")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst_name} at {ratio}")
    if not step_err <= 1e-4:
        raise AssertionError(f"card and CPU losses after one step disagree: {losses}")
    return {"grad_max_rel_err": ratio, "grad_worst_param": worst_name, "losses": losses,
            "loss_after_step_rel_err": step_err}


def phase_serve(torch, seed, np):
    return _serve(torch, seed, np, "serve", "Hyena-125M", "hyena",
                  {"spectrum": N_LAYER, "monarch_conv": N_LAYER, "depthwise": N_LAYER})


def phase_h3_serve(torch, seed, np):
    """H3-125M answers the serve phase's requests, then its forwards."""
    return _serve(torch, seed, np, "h3_serve", "H3-125M", "h3", H3_LAUNCHES)


def _serve(torch, seed, np, what, name, mixer, per_fwd):
    """The preset's LM (``mixer``) answers PROMPTS requests through
    generate after one scoring forward; each forward launches per_fwd."""
    from flashfftconv_tpu_torch.utils.generation import generate

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = _hyena_125m(torch, seed, dev, mixer=mixer).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{name}: {n_params / 1e6:.2f}M params, built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    ids = torch.zeros(B, L_MAX, dtype=torch.long)
    for i, n in enumerate(PROMPTS):
        ids[i, :n] = torch.from_numpy(rng.integers(0, VOCAB, n))
    ids = ids.to(dev)
    lengths = torch.tensor(PROMPTS, device=dev)

    fwd_ms = []

    def counted(tokens):
        """One timed forward (the caller reads its result on the host anyway)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model(tokens)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t) * 1e3)
        return out

    with torch.inference_mode():
        model(ids)  # warm-up: cuBLAS handles, library loads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = _counters(per_fwd)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits = counted(ids)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        if logits.shape != (B, L_MAX, model.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
        del logits
        t0 = time.perf_counter()
        out = generate(counted, ids, NEW_TOKENS, L_MAX, temperature=0.0,
                       prompt_lengths=lengths)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_fwd = len(fwd_ms)
    for i, n in enumerate(PROMPTS):
        new = out[i, n : n + NEW_TOKENS]
        if not bool(((new >= 0) & (new < model.vocab_size)).all()):
            raise AssertionError(f"request {i}: generated ids out of range: {new.tolist()}")
        if not torch.equal(out[i, :n], ids[i, :n]):
            raise AssertionError(f"request {i}: prompt changed")
    if n_fwd != 1 + NEW_TOKENS:
        raise AssertionError(f"{n_fwd} forwards, expected {1 + NEW_TOKENS}")
    for kernel, count in launches.items():
        if count != per_fwd[kernel] * n_fwd:
            raise AssertionError(f"{kernel} launched {count} times in {n_fwd} forwards, "
                                 f"expected {per_fwd[kernel]} a forward")
    med = float(np.median(fwd_ms))
    res = {
        "forwards": n_fwd,
        "launches": launches,
        "forward_ms": fwd_ms,
        "forward_ms_median": med,
        "forward_ms_max": max(fwd_ms),
        "context_tokens_per_s": B * L_MAX / (med / 1e3),
        "score_s": score_s,
        "generate_s": gen_s,
        "generated_tokens_per_s": B * NEW_TOKENS / gen_s,
        "peak_memory_bytes": peak,
    }
    log(f"{what}: {n_fwd} forwards, launches {launches}, forward median {med:.2f} ms max "
        f"{max(fwd_ms):.2f} ms ({res['context_tokens_per_s']:.0f} context tokens/s), "
        f"generate {gen_s:.3f} s for {B * NEW_TOKENS} tokens "
        f"({res['generated_tokens_per_s']:.1f} new tokens/s), peak memory {peak / 2**30:.2f} GiB")
    return res


def phase_parity(torch, seed):
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

    kw = dict(d_model=128, n_layer=2, d_inner=512, vocab_size=256, l_max=1024,
              mixer_kwargs={"conv_dtype": torch.float32}, dtype=torch.float32)
    models = {
        dev: ConvLMHeadModel(**kw, device=dev,
                             generator=torch.Generator().manual_seed(seed)).eval()
        for dev in ("cpu", "cuda")
    }
    ids = torch.randint(0, 256, (2, 1024), generator=torch.Generator().manual_seed(seed + 1))
    with torch.inference_mode():
        ref = models["cpu"](ids)
        got = models["cuda"](ids.cuda()).cpu()
    err = float((got - ref).abs().max())
    log(f"parity: 2-layer f32 LM, card (kernels) vs CPU (plain): max_abs_err={err:.3e} "
        f"tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")
    return {"logits_max_abs_err": err}


def phase_dna(torch, seed, np):
    """HyenaDNA large-1m at full width and depth answers DNA_REQUESTS scoring
    requests (B=1 each, one plan at FFT size 2 * l_max) through
    models.dna.score, then DNA_WARMUP + DNA_TIMED forwards at l_max bases."""
    from flashfftconv_tpu_torch.models import dna

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(seed)).eval()
    cfg = dna.MODEL_CONFIGS[DNA_MODEL]
    if (cfg["d_model"], cfg["n_layer"], cfg["l_max"]) != (DNA_D_MODEL, DNA_N_LAYER, DNA_L_MAX):
        raise AssertionError(f"preset {DNA_MODEL} is {cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"HyenaDNA {DNA_MODEL}: {n_params / 1e6:.2f}M params, d_model {DNA_D_MODEL}, "
        f"{DNA_N_LAYER} layers, l_max {DNA_L_MAX}, built in {time.perf_counter() - t0:.1f} s")
    genome = dna.synthetic_genome(seed)
    rng = np.random.default_rng(seed)
    counters = _counters(DNA_LAUNCHES)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    requests = []
    for length in DNA_REQUESTS:
        off = int(rng.integers(0, genome.size - length))
        ids = torch.from_numpy(genome[off : off + length].astype(np.int64))[None].to(dev)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dna.score(model, ids)
        bits, nxt = float(out["bits_per_base"][0]), int(out["next_base"][0])  # waits
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: fn.launches - before[name] for name, fn in counters.items()}
        if not bool(out["finite"]) or not math.isfinite(bits):
            raise AssertionError(f"request of {length} bases: non-finite logits or score {bits}")
        if not 0 <= nxt < len(dna.DNA_VOCAB):
            raise AssertionError(f"request of {length} bases: next base {nxt} out of range")
        if counts != DNA_LAUNCHES:
            raise AssertionError(f"request of {length} bases launched {counts}, expected "
                                 f"{DNA_LAUNCHES}")
        requests.append({"bases": length, "bits_per_base": bits, "next_base": "ACGTN"[nxt],
                         "ms": ms})
        log(f"dna: request of {length} bases: {bits:.4f} bits/base, next base "
            f"{'ACGTN'[nxt]}, {ms:.1f} ms, launches {counts}")
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(DNA_WARMUP + DNA_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (1, DNA_L_MAX, model.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
        del logits
    launches = {name: fn.launches for name, fn in counters.items()}
    n_fwd = len(DNA_REQUESTS) + DNA_WARMUP + DNA_TIMED
    if launches != {name: n * n_fwd for name, n in DNA_LAUNCHES.items()}:
        raise AssertionError(f"{n_fwd} forwards launched {launches}, expected {DNA_LAUNCHES} each")
    peak = torch.cuda.max_memory_allocated()
    timed = fwd_ms[DNA_WARMUP:]
    med = float(np.median(timed))
    res = {"requests": requests, "forwards": n_fwd, "launches": launches, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(timed),
           "tokens_per_ms": DNA_L_MAX / med, "peak_memory_bytes": peak}
    log(f"dna: forward at {DNA_L_MAX} bases (B=1, bf16): median {med:.2f} ms max "
        f"{max(timed):.2f} ms over {DNA_TIMED} timed forwards, {res['tokens_per_ms']:.1f} "
        f"tokens/ms, peak memory {peak / 2**30:.2f} GiB, launches a forward {DNA_LAUNCHES}")
    return res


def _dna_train_step(torch, model):
    """The examples/hyena_dna train step over model: clip 1.0, then AdamW at
    lr 6e-4, weight decay 0.1, no schedule; no dropout (eval mode)."""
    from flashfftconv_tpu_torch.utils.train import dna_optimizer, make_train_step

    return make_train_step(model.eval(), dna_optimizer(model), None, clip=1.0)


def phase_dna_train(torch, seed, np):
    """HyenaDNA large-1m at full width and depth takes DNA_TRAIN_WARMUP +
    DNA_TRAIN_TIMED steps at B=1 and l_max bases."""
    from flashfftconv_tpu_torch.models import dna
    from flashfftconv_tpu_torch.utils.data import lm_batches

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    levers = dna.train_config(DNA_MODEL)
    model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(seed), **levers)
    step = _dna_train_step(torch, model)
    batches = lm_batches(dna.synthetic_genome(seed), 1, DNA_L_MAX, np.random.default_rng(seed))
    n_steps = DNA_TRAIN_WARMUP + DNA_TRAIN_TIMED
    counters = _counters(DNA_TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, per_step = [], [], []
    try:
        for _ in range(n_steps):
            x, y = (torch.from_numpy(a.astype(np.int64)).to(dev) for a in next(batches))
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(x, y)
            loss = float(out["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(f"HyenaDNA {DNA_MODEL} train step ran out of memory with levers "
                             f"{levers}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                             "GiB") from e
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != DNA_TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {DNA_TRAIN_LAUNCHES}")
    timed = step_ms[DNA_TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "levers": levers, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med, "step_ms_max": max(timed),
           "tokens_per_s": DNA_L_MAX / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak}
    log(f"dna_train: HyenaDNA {DNA_MODEL} B=1 L={DNA_L_MAX} bf16, levers {levers}, {n_steps} "
        f"steps (lr 6e-4, wd 0.1, clip 1.0), losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"dna_train: step median {med:.2f} ms max {max(timed):.2f} ms over {DNA_TRAIN_TIMED} "
        f"timed steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    del model, step
    torch.cuda.empty_cache()
    return res


def _all_levers(torch):
    """Every memory lever of the 1M-base recipe as build_model overrides; the
    two dtype levers at f32, so that each lever is exact and the model must
    agree with the lever-free one."""
    return dict(
        remat=True, scan_blocks=True, inner_remat=True, mlp_l_chunks=8,
        mixer_kwargs={"conv_dtype": torch.float32, "conv_h_chunks": 4, "proj_l_chunks": 8,
                      "proj_out_f32": True, "filter_output_dtype": torch.float32,
                      "filter_args": {"emb_dim": 5, "mlp_dtype": torch.float32}})


def _loss_and_grads(torch, model, ids):
    """The LM loss and every parameter's grad (a parameter the forward never
    reads, as an M2 filter's bias, has none and is left out)."""
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    model.zero_grad(set_to_none=True)
    loss = cross_entropy(model(ids[:, :-1]), ids[:, 1:])
    loss.backward()
    return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _worst_grad(grads, ref):
    """(largest max |dgrad| / max |grad| over the parameters, its name)."""
    worst = max(((g.cpu() - ref[n].cpu()).abs().max() / ref[n].cpu().abs().max().clamp(min=1e-12),
                 n) for n, g in grads.items())
    return float(worst[0]), worst[1]


def phase_long_parity(torch, seed, np):
    """A 2-layer f32 HyenaDNA at l_max 65536 (FFT size 131072) with the same
    weights on the card (long kernels) and on the CPU (plain versions):
    logits, then grads (twice on the card, bit for bit); then every memory
    lever on against none, on the card."""
    from flashfftconv_tpu_torch.models import dna

    l_max = 65536
    models = {
        dev: dna.build_model("tiny-1k", d_model=64, n_layer=2, l_max=l_max, dtype=torch.float32,
                             mixer_kwargs={"conv_dtype": torch.float32}, device=dev,
                             generator=torch.Generator().manual_seed(seed)).eval()
        for dev in ("cpu", "cuda")
    }
    ids = torch.from_numpy(dna.synthetic_genome(seed + 1, n=l_max).astype(np.int64))[None]
    n0 = _counters(("long_conv",))["long_conv"].launches
    with torch.inference_mode():
        ref = models["cpu"](ids)
        got = models["cuda"](ids.cuda()).cpu()
    if _counters(("long_conv",))["long_conv"].launches != n0 + 2:
        raise AssertionError("the card's forward did not run the long conv once a layer")
    err = float((got - ref).abs().max())
    log(f"long_parity: 2-layer f32 HyenaDNA at {l_max} bases, card (long kernels) vs CPU "
        f"(plain): max_abs_err={err:.3e} tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")
    res = {"logits_max_abs_err": err}

    ids = torch.from_numpy(dna.synthetic_genome(seed + 2, n=l_max + 1).astype(np.int64))[None]
    bwd = _counters(("long_conv_bwd", "long_dk_finish"))
    before = {name: fn.launches for name, fn in bwd.items()}
    loss_cpu, grads_cpu = _loss_and_grads(torch, models["cpu"], ids)
    loss_card, grads_card = _loss_and_grads(torch, models["cuda"], ids.cuda())
    _, grads_again = _loss_and_grads(torch, models["cuda"], ids.cuda())
    for name, fn in bwd.items():
        if fn.launches - before[name] != 4:
            raise AssertionError(f"{name} launched {fn.launches - before[name]} times in two "
                                 "backwards of 2 layers, expected 4")
    ratio, worst = _worst_grad(grads_card, grads_cpu)
    # The embedding table's grad is excepted: PyTorch's embedding backward adds
    # the 65536 rows' grads into 8 table rows with float atomics, in an order
    # that changes from run to run. Every other grad comes through the port's
    # kernels, matmuls and elementwise passes, none of which uses atomics.
    differ = [n for n, gr in grads_card.items()
              if n != "embeddings.weight" and not torch.equal(gr, grads_again[n])]
    log(f"long_parity: grads, card (long backward kernels) vs CPU (plain) over "
        f"{len(grads_cpu)} params: max |dgrad| / max |grad| = {ratio:.3e} ({worst}), tol 1e-3; "
        f"loss {loss_card:.6f} vs {loss_cpu:.6f}; a second backward on the card differs in "
        f"{len(differ)} of the {len(grads_cpu) - 1} params outside the embedding table {differ}")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst} at {ratio}")
    if differ:
        raise AssertionError(f"two backwards on the card differ in {differ}")
    res.update(grad_max_rel_err=ratio, grad_worst_param=worst)
    del models, grads_cpu, grads_card, grads_again

    l_max, out = 131072, {}
    ids = torch.from_numpy(dna.synthetic_genome(seed + 3, n=l_max + 1).astype(np.int64))[None]
    ids = ids.cuda()
    levers = _all_levers(torch)
    for name, kw in (("none", {"mixer_kwargs": {"conv_dtype": torch.float32}}), ("all", levers)):
        model = dna.build_model("tiny-1k", d_model=DNA_D_MODEL, n_layer=2, l_max=l_max,
                                dtype=torch.float32, device="cuda",
                                generator=torch.Generator().manual_seed(seed), **kw).eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[name] = (*_loss_and_grads(torch, model, ids), torch.cuda.max_memory_allocated())
        del model
        torch.cuda.empty_cache()
    ratio, worst = _worst_grad(out["all"][1], out["none"][1])
    loss_err = abs(out["all"][0] - out["none"][0]) / abs(out["none"][0])
    log(f"long_parity: 2-layer d_model {DNA_D_MODEL} f32 HyenaDNA at {l_max} bases on the card, "
        f"every lever on ({levers}) vs none: loss {out['all'][0]:.6f} vs "
        f"{out['none'][0]:.6f} (rel err {loss_err:.3e}), max |dgrad| / max |grad| = {ratio:.3e} "
        f"({worst}), tol 1e-4; peak memory {out['all'][2] / 2**30:.2f} vs "
        f"{out['none'][2] / 2**30:.2f} GiB")
    if not (ratio <= 1e-4 and loss_err <= 1e-4):
        raise AssertionError(f"levers on and off disagree: loss {loss_err}, {worst} at {ratio}")
    res.update(levers_grad_max_rel_err=ratio, levers_loss_rel_err=loss_err,
               levers_peak_memory_bytes=out["all"][2], no_levers_peak_memory_bytes=out["none"][2])
    return res


def _m2_bert(torch, seed, dev):
    from flashfftconv_tpu_torch.models import bert

    model = bert.build_model(BERT_MODEL, dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(seed))
    cfg = bert.PRESETS[BERT_MODEL]
    if (cfg["d_model"], cfg["n_layer"], cfg["l_max"]) != (BERT_D_MODEL, BERT_N_LAYER, BERT_L):
        raise AssertionError(f"preset {BERT_MODEL} is {cfg}")
    return model


def phase_bert(torch, seed, np):
    """M2-BERT base-110M at full width and depth answers BERT_REQUESTS
    fill-mask requests through models.bert.fill_mask, then BERT_WARMUP +
    BERT_TIMED forwards at B=128, L=128."""
    from flashfftconv_tpu_torch.models import bert
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _m2_bert(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"M2-BERT {BERT_MODEL}: {n_params / 1e6:.2f}M params, d_model {BERT_D_MODEL}, "
        f"{BERT_N_LAYER} layers, l_max {BERT_L}, built in {time.perf_counter() - t0:.1f} s")
    tokens = _corpus(np)
    rng = np.random.default_rng(seed)
    counters = _counters(BERT_LAUNCHES)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    requests = []
    for b, length in BERT_REQUESTS:
        x, labels = (torch.from_numpy(a).to(dev) for a in next(mlm_batches(tokens, b, length, rng)))
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bert.fill_mask(model, x, labels)
        acc = float((out["accuracy"] * (labels >= 0).sum(1)).sum() / (labels >= 0).sum())  # waits
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: fn.launches - before[name] for name, fn in counters.items()}
        top1 = out["top1"]
        if not bool(out["finite"]) or top1.shape != (b, length):
            raise AssertionError(f"request {(b, length)}: non-finite logits or top-1 of shape "
                                 f"{tuple(top1.shape)}")
        if not bool(((top1 >= 0) & (top1 < model.vocab_size)).all()):
            raise AssertionError(f"request {(b, length)}: top-1 ids out of range")
        if counts != BERT_LAUNCHES:
            raise AssertionError(f"request {(b, length)} launched {counts}, expected "
                                 f"{BERT_LAUNCHES}")
        requests.append({"batch": b, "length": length, "masked": int((labels >= 0).sum()),
                         "masked_accuracy": acc, "ms": ms})
        log(f"bert: fill-mask request B={b} L={length}: {requests[-1]['masked']} masked, "
            f"top-1 accuracy {acc:.4f}, {ms:.1f} ms, launches {counts}")
    x = next(mlm_batches(tokens, BERT_B, BERT_L, rng))[0]
    x = torch.from_numpy(x).to(dev)
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(BERT_WARMUP + BERT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (BERT_B, BERT_L, model.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
        del logits
    launches = {name: fn.launches for name, fn in counters.items()}
    n_fwd = len(BERT_REQUESTS) + BERT_WARMUP + BERT_TIMED
    if launches != {name: n * n_fwd for name, n in BERT_LAUNCHES.items()}:
        raise AssertionError(f"{n_fwd} forwards launched {launches}, expected {BERT_LAUNCHES} "
                             "each")
    peak = torch.cuda.max_memory_allocated()
    timed = fwd_ms[BERT_WARMUP:]
    med = float(np.median(timed))
    res = {"requests": requests, "forwards": n_fwd, "launches": launches, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(timed),
           "tokens_per_ms": BERT_B * BERT_L / med, "seqs_per_s": BERT_B / (med / 1e3),
           "peak_memory_bytes": peak}
    log(f"bert: forward at B={BERT_B} L={BERT_L} (bf16): median {med:.2f} ms max "
        f"{max(timed):.2f} ms over {BERT_TIMED} timed forwards, {res['tokens_per_ms']:.1f} "
        f"tokens/ms, {res['seqs_per_s']:.1f} seqs/s, peak memory {peak / 2**30:.2f} GiB, "
        f"launches a forward {BERT_LAUNCHES}")
    del model
    torch.cuda.empty_cache()
    return res


def _bert_train_step(torch, model):
    """The examples/bert train step over model: clip 1.0, then AdamW at lr
    8e-4, weight decay 1e-5 on every parameter; the MLM loss and accuracy
    over the masked positions."""
    from flashfftconv_tpu_torch.utils.train import bert_optimizer, make_train_step, mlm_loss

    return make_train_step(model, bert_optimizer(model), None, clip=1.0, loss_fn=mlm_loss)


def phase_bert_train(torch, seed, np):
    """M2-BERT base-110M at full width and depth takes BERT_TRAIN_WARMUP +
    BERT_TRAIN_TIMED steps at B=128, L=128, dropout on."""
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.manual_seed(seed)  # the dropout masks repeat from run to run
    model = _m2_bert(torch, seed, dev).train()
    step = _bert_train_step(torch, model)
    batches = mlm_batches(_corpus(np), BERT_B, BERT_L, np.random.default_rng(seed))
    n_steps = BERT_TRAIN_WARMUP + BERT_TRAIN_TIMED
    counters = _counters(BERT_TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, accs, step_ms, per_step = [], [], [], []
    for _ in range(n_steps):
        x, y = (torch.from_numpy(a).to(dev) for a in next(batches))
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(x, y)
        loss = float(out["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        accs.append(float(out["accuracy"]))
        per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite MLM loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"MLM loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != BERT_TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {BERT_TRAIN_LAUNCHES}")
    timed = step_ms[BERT_TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "losses": losses, "accuracies": accs, "step_ms": step_ms,
           "step_ms_median": med, "step_ms_max": max(timed),
           "tokens_per_s": BERT_B * BERT_L / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak}
    log(f"bert_train: M2-BERT {BERT_MODEL} B={BERT_B} L={BERT_L} bf16, dropout 0.1, {n_steps} "
        f"steps (lr 8e-4, wd 1e-5, clip 1.0), MLM losses {' '.join(f'{v:.4f}' for v in losses)}, "
        f"accuracies {' '.join(f'{v:.4f}' for v in accs)}")
    log(f"bert_train: step median {med:.2f} ms max {max(timed):.2f} ms over {BERT_TRAIN_TIMED} "
        f"timed steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    del model, step
    torch.cuda.empty_cache()
    return res


def phase_bert_parity(torch, seed, np):
    """A 2-layer f32 M2BertForMaskedLM (d_model 128, l_max 128, bidirectional
    kernels, residual long conv) with the same weights on the card (direct
    kernels) and on the CPU (plain versions): logits, the masked-LM grads,
    and a second backward on the card bit for bit. B = 20 spans two chunks
    of the direct backward's batch walk."""
    from flashfftconv_tpu_torch.models.bert import M2BertForMaskedLM
    from flashfftconv_tpu_torch.utils.data import mlm_batches
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    kw = dict(vocab_size=300, d_model=128, n_layer=2, d_inner=512, l_max=128, mlp_nblocks=0,
              tie_mlm_head=True, conv_dtype=torch.float32)
    models = {dev: M2BertForMaskedLM(**kw, device=dev,
                                     generator=torch.Generator().manual_seed(seed)).eval()
              for dev in ("cpu", "cuda")}
    x, y = (torch.from_numpy(a) for a in next(mlm_batches(_corpus(np), 20, 128,
                                                          np.random.default_rng(seed + 1))))
    n0 = _counters(("direct_conv",))["direct_conv"].launches
    with torch.inference_mode():
        ref = models["cpu"](x)
        got = models["cuda"](x.cuda()).cpu()
    if _counters(("direct_conv",))["direct_conv"].launches != n0 + 4:
        raise AssertionError("the card's forward did not run two direct convs a layer")
    err = float((got - ref).abs().max())
    log(f"bert_parity: 2-layer f32 M2-BERT at L=128, B=20, card (direct kernels) vs CPU (plain): "
        f"max_abs_err={err:.3e} tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")

    def loss_and_grads(model, dev):
        model.zero_grad(set_to_none=True)
        loss = cross_entropy(model(x.to(dev)), y.to(dev), -100)
        loss.backward()
        return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    bwd = _counters(("direct_conv_bwd",))["direct_conv_bwd"]
    n0 = bwd.launches
    loss_cpu, grads_cpu = loss_and_grads(models["cpu"], "cpu")
    loss_card, grads_card = loss_and_grads(models["cuda"], "cuda")
    _, grads_again = loss_and_grads(models["cuda"], "cuda")
    if bwd.launches - n0 != 8:
        raise AssertionError(f"direct_conv_bwd launched {bwd.launches - n0} times in two "
                             "backwards of 2 layers, expected 8")
    if set(grads_card) != set(grads_cpu):
        raise AssertionError("the card and the CPU grads cover other parameters")
    ratio, worst = _worst_grad(grads_card, grads_cpu)
    # The embedding tables' grads are excepted: PyTorch's embedding backward
    # adds rows with float atomics, in an order that changes from run to run.
    differ = [n for n, gr in grads_card.items()
              if "embeddings" not in n and not torch.equal(gr, grads_again[n])]
    log(f"bert_parity: masked-LM grads, card (direct backward kernels) vs CPU (plain) over "
        f"{len(grads_cpu)} params: max |dgrad| / max |grad| = {ratio:.3e} ({worst}), tol 1e-3; "
        f"loss {loss_card:.6f} vs {loss_cpu:.6f}; a second backward on the card differs in "
        f"{len(differ)} params outside the embedding tables {differ}")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst} at {ratio}")
    if differ:
        raise AssertionError(f"two backwards on the card differ in {differ}")
    return {"logits_max_abs_err": err, "grad_max_rel_err": ratio, "grad_worst_param": worst}


def _gpt2(torch, seed, dev, **kw):
    from flashfftconv_tpu_torch.models.gpt import GPTLMHeadModel

    cfg = dict(d_model=GPT_D_MODEL, n_layer=GPT_N_LAYER, d_inner=4 * GPT_D_MODEL,
               vocab_size=GPT_VOCAB, l_max=GPT_L_MAX, num_heads=GPT_HEADS, dtype=torch.bfloat16)
    return GPTLMHeadModel(**{**cfg, **kw}, device=dev,
                          generator=torch.Generator().manual_seed(seed))


def _decode_logits(torch, model, ids, cache_dtype):
    """The logits of model.step at every position of ids (1, n) over fresh
    caches of cache_dtype."""
    caches = model.init_cache(1, ids.shape[1], cache_dtype)
    return torch.cat([model.step(ids[:, p : p + 1], caches, p)[0] for p in range(ids.shape[1])],
                     dim=1)


def phase_gpt_serve(torch, seed, np):
    """GPT-2 124M answers GPT_PROMPTS requests through generate_kv, then
    GPT_WARMUP + GPT_TIMED scoring forwards at B=8, L=1024 through the
    attention kernel; one request's decode logits against the forward's."""
    from flashfftconv_tpu_torch.utils.generation import generate_kv

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = _gpt2(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"GPT-2 124M: {n_params / 1e6:.2f}M params, built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    counters = _counters(GPT_TRAIN_LAUNCHES)
    res = {}
    with torch.inference_mode():
        req_s, outs = [], []
        for fn in counters.values():
            fn.launches = 0
        for n in GPT_PROMPTS:
            prompt = torch.from_numpy(rng.integers(0, GPT_VOCAB, (1, n))).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate_kv(model, prompt, NEW_TOKENS, n + NEW_TOKENS, temperature=0.0)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t0)
            new = out[0, n:]
            if out.shape != (1, n + NEW_TOKENS) or not torch.equal(out[:, :n], prompt) or \
                    not bool(((new >= 0) & (new < model.vocab_size)).all()):
                raise AssertionError(f"request of {n} tokens: bad output {out[0, n - 2:].tolist()}")
            outs.append(out)
        decode_launches = {name: fn.launches for name, fn in counters.items()}
        if any(decode_launches.values()):
            raise AssertionError(f"KV-cached decoding launched {decode_launches}; it runs plain "
                                 "attention over the cache")
        log(f"gpt_serve: {len(GPT_PROMPTS)} requests (prompts {GPT_PROMPTS}, {NEW_TOKENS} greedy "
            f"tokens each) through generate_kv in {' '.join(f'{t:.3f}' for t in req_s)} s "
            f"({len(GPT_PROMPTS) * NEW_TOKENS / sum(req_s):.1f} new tokens/s over "
            f"{sum(GPT_PROMPTS) + len(GPT_PROMPTS) * (NEW_TOKENS - 1)} decode steps)")

        # Decode logits of the first request against the full forward's. The
        # cache's precision shows in an f32 GPT-2 124M (the same geometry and
        # seed): there the step over an f32 cache differs from the forward
        # (flash_attn_fwd) only by f32 rounding, held at 1e-4 of the largest
        # |logit| as tests/test_torch_attention.py holds the CPU step, and a
        # bf16 cache shows its own rounding beside it.
        ids = outs[0]
        f32_model = _gpt2(torch, seed, dev, dtype=torch.float32).eval()
        full = f32_model(ids)[0]
        dev_f32 = float((_decode_logits(torch, f32_model, ids, torch.float32)[0] - full)
                        .abs().max())
        dev_f32_bf16 = float((_decode_logits(torch, f32_model, ids, torch.bfloat16)[0] - full)
                             .abs().max())
        scale = float(full.abs().max())
        tol = 1e-4 * scale
        log(f"gpt_serve: f32 GPT-2 124M, decode-step logits of the {ids.shape[1]}-token "
            f"request vs the full forward (flash_attn_fwd): f32 cache max_abs_err="
            f"{dev_f32:.3e} tol={tol:.3e} (1e-4 of |logits| <= {scale:.2f}); bf16 cache "
            f"{dev_f32_bf16:.3e}")
        if not dev_f32 <= tol:
            raise AssertionError(f"f32 decode logits with an f32 cache disagree with the "
                                 f"forward: {dev_f32} > {tol}")
        del f32_model, full
        # The served bf16 model: its step's (1, D) matmuls and the forward's
        # (L, D) ones round the MLPs' bf16 operands apart, a few bf16 ulps
        # through 12 layers, whatever the cache holds. Its readings are
        # printed, with a loose 2e-2 of the largest |logit| against gross
        # faults.
        full = model(ids)[0]
        dev_bf16_f32 = float((_decode_logits(torch, model, ids, torch.float32)[0] - full)
                             .abs().max())
        dev_bf16 = float((_decode_logits(torch, model, ids, torch.bfloat16)[0] - full)
                         .abs().max())
        bscale = float(full.abs().max())
        log(f"gpt_serve: bf16 GPT-2 124M, the same request: f32 cache max_abs_err="
            f"{dev_bf16_f32:.3e}, bf16 cache {dev_bf16:.3e} (|logits| <= {bscale:.2f}, "
            f"bound {2e-2 * bscale:.3e})")
        if not max(dev_bf16_f32, dev_bf16) <= 2e-2 * bscale:
            raise AssertionError(f"bf16 decode logits disagree with the forward beyond bf16 "
                                 f"rounding: {dev_bf16_f32}, {dev_bf16} > {2e-2 * bscale}")

        ids = torch.from_numpy(rng.integers(0, GPT_VOCAB, (GPT_SERVE_B, GPT_L_MAX))).to(dev)
        for _ in range(GPT_WARMUP):
            model(ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        fwd_ms = []
        for _ in range(GPT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {name: fn.launches for name, fn in counters.items()}
        if logits.shape != (GPT_SERVE_B, GPT_L_MAX, model.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
    peak = torch.cuda.max_memory_allocated()
    want = {name: GPT_TIMED * GPT_LAUNCHES.get(name, 0) for name in counters}
    if launches != want:
        raise AssertionError(f"{GPT_TIMED} forwards launched {launches}, expected {want}")
    med = float(np.median(fwd_ms))
    res.update(requests_s=req_s, decode_f32_cache_max_abs_err=dev_f32,
               decode_f32_model_bf16_cache_max_abs_err=dev_f32_bf16,
               decode_bf16_model_f32_cache_max_abs_err=dev_bf16_f32,
               decode_bf16_model_bf16_cache_max_abs_err=dev_bf16, forward_ms=fwd_ms,
               forward_ms_median=med, forward_ms_max=max(fwd_ms),
               tokens_per_s=GPT_SERVE_B * GPT_L_MAX / (med / 1e3), launches=launches,
               peak_memory_bytes=peak)
    log(f"gpt_serve: B={GPT_SERVE_B} L={GPT_L_MAX} forward median {med:.2f} ms max "
        f"{max(fwd_ms):.2f} ms over {GPT_TIMED} ({res['tokens_per_s']:.0f} tokens/s), launches "
        f"{launches}, peak memory {peak / 2**30:.2f} GiB")
    return res


def _lm_train(torch, seed, np, what, model, b, length, warmup, timed, want):
    """warmup + timed steps of the examples/lm recipe (AdamW lr 3e-4 with 2
    warm-up steps, weight decay 0.1, clip 1.0) on byte data: a finite,
    falling loss and the launches of `want` every step."""
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    n_steps = warmup + timed
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=n_steps)
    step = make_train_step(model, opt, sched, clip=1.0)
    batches = _train_batches(torch, np, seed, "cuda", n_steps, b, length)
    torch.cuda.empty_cache()
    losses, step_ms, launches, peak = _train_loop(torch, what, step, batches, want)
    timed_ms = step_ms[warmup:]
    med = float(np.median(timed_ms))
    res = {"steps": n_steps, "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "step_ms_max": max(timed_ms), "tokens_per_s": b * length / (med / 1e3),
           "launches": launches, "peak_memory_bytes": peak}
    log(f"{what} B={b} L={length} bf16, {n_steps} steps (lr 3e-4, wd 0.1, clip 1.0, warmup 2), "
        f"losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"{what}: step median {med:.2f} ms max {max(timed_ms):.2f} ms over {timed} timed steps "
        f"({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, launches a "
        f"step {want}")
    return res


def phase_gpt_train(torch, seed, np):
    """GPT-2 124M (B=16, L=1024, bf16 activations, embedding dropout 0.1)
    takes GPT_TRAIN_WARMUP + GPT_TRAIN_TIMED steps of the examples/lm recipe
    on byte data."""
    torch.manual_seed(seed)
    model = _gpt2(torch, seed, "cuda").train()
    return _lm_train(torch, seed, np, "gpt_train: GPT-2 124M", model, GPT_TRAIN_B,
                               GPT_L_MAX, GPT_TRAIN_WARMUP, GPT_TRAIN_TIMED, GPT_TRAIN_LAUNCHES)


def _attention_lm_parity(torch, seed, np, what, length, want, **kw):
    """A 2-layer f32 GPT (d_model 256, 4 heads of 64) with the same weights
    on the card (kernels) and on the CPU (plain versions): logits within
    2e-3, grads within 1e-3 of each parameter's largest |grad|, a second
    backward on the card bit for bit (but the embedding table's), and the
    launches of `want` over one forward and two train passes."""
    kw = dict(d_model=256, n_layer=2, d_inner=1024, vocab_size=256, l_max=length, num_heads=4,
              dtype=torch.float32, **kw)
    models = {dev: _gpt2(torch, seed, dev, **kw).eval() for dev in ("cpu", "cuda")}
    x, y = _train_batches(torch, np, seed + 1, "cpu", 1, 2, length)[0]
    ids = torch.cat([x, y[:, -1:]], dim=1)  # L + 1 bytes: inputs and targets
    counters = _counters(want)
    before = {name: fn.launches for name, fn in counters.items()}
    with torch.inference_mode():
        ref = models["cpu"](ids[:, :-1])
        got = models["cuda"](ids[:, :-1].cuda()).cpu()
    err = float((got - ref).abs().max())
    log(f"{what} at L={length}, B=2, card (kernels) vs CPU (plain): max_abs_err={err:.3e} "
        f"tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")
    loss_cpu, grads_cpu = _loss_and_grads(torch, models["cpu"], ids)
    loss_card, grads_card = _loss_and_grads(torch, models["cuda"], ids.cuda())
    _, grads_again = _loss_and_grads(torch, models["cuda"], ids.cuda())
    counts = {name: fn.launches - before[name] for name, fn in counters.items()}
    if counts != want:
        raise AssertionError(f"one forward and two train passes launched {counts}, "
                             f"expected {want}")
    ratio, worst = _worst_grad(grads_card, grads_cpu)
    # The embedding table's grad is excepted: PyTorch's embedding backward adds
    # rows with float atomics, in an order that changes from run to run.
    differ = [n for n, gr in grads_card.items()
              if n != "embeddings.weight" and not torch.equal(gr, grads_again[n])]
    log(f"{what}: grads, card (backward kernels) vs CPU (plain) over {len(grads_cpu)} params: "
        f"max |dgrad| / max |grad| = {ratio:.3e} ({worst}), tol 1e-3; loss {loss_card:.6f} vs "
        f"{loss_cpu:.6f}; a second backward on the card differs in {len(differ)} params "
        f"outside the embedding table {differ}")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst} at {ratio}")
    if differ:
        raise AssertionError(f"two backwards on the card differ in {differ}")
    return {"logits_max_abs_err": err, "grad_max_rel_err": ratio, "grad_worst_param": worst}


def phase_gpt_parity(torch, seed, np):
    """A 2-layer f32 GPT (d_model 256, 4 heads of 64, l_max 1024) on the card
    (flash-attention kernels) against the CPU."""
    want = {"flash_attn_fwd": 6, "flash_attn_bwd_dkv": 4, "flash_attn_bwd_dq": 4}
    return _attention_lm_parity(torch, seed, np, "gpt_parity: 2-layer f32 GPT", GPT_L_MAX, want)


def _window_gpt(torch, seed, dev, **kw):
    """The windowed GPT at GPT-Neo-125M's sizes (see WIN_L_MAX)."""
    return _gpt2(torch, seed, dev, **{"l_max": WIN_L_MAX, "mixer_kwargs": {"window": WIN_W},
                                      **kw})


def phase_window_serve(torch, seed, np):
    """The windowed GPT answers WIN_PROMPTS requests through generate_kv (the
    1500-token prompt is longer than the window, so the cached step's window
    mask decides), then WIN_WARMUP + WIN_TIMED scoring forwards at B=4,
    L=2048 through the splash forward kernel; the decode logits of an f32
    copy against its forward's."""
    from flashfftconv_tpu_torch.utils.generation import generate_kv

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = _window_gpt(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"windowed GPT (GPT-Neo-125M sizes, window {WIN_W}): {n_params / 1e6:.2f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    counters = _counters(WIN_TRAIN_LAUNCHES)
    with torch.inference_mode():
        req_s, outs = [], []
        for fn in counters.values():
            fn.launches = 0
        for n in WIN_PROMPTS:
            prompt = torch.from_numpy(rng.integers(0, GPT_VOCAB, (1, n))).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate_kv(model, prompt, NEW_TOKENS, n + NEW_TOKENS, temperature=0.0)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t0)
            new = out[0, n:]
            if out.shape != (1, n + NEW_TOKENS) or not torch.equal(out[:, :n], prompt) or \
                    not bool(((new >= 0) & (new < model.vocab_size)).all()):
                raise AssertionError(f"request of {n} tokens: bad output {out[0, n - 2:].tolist()}")
            outs.append(out)
        decode_launches = {name: fn.launches for name, fn in counters.items()}
        if any(decode_launches.values()):
            raise AssertionError(f"KV-cached decoding launched {decode_launches}; it runs plain "
                                 "attention over the cache")
        log(f"window_serve: {len(WIN_PROMPTS)} requests (prompts {WIN_PROMPTS}, {NEW_TOKENS} "
            f"greedy tokens each) through generate_kv in {' '.join(f'{t:.3f}' for t in req_s)} "
            f"s ({len(WIN_PROMPTS) * NEW_TOKENS / sum(req_s):.1f} new tokens/s)")

        # The decode-step logits of the 1500-token request against the full
        # forward's (the splash kernel's window) in an f32 copy with an f32
        # cache: they differ by f32 rounding only, held at 1e-4 of the largest
        # |logit| as gpt_serve holds GPT-2's.
        ids = outs[-1]
        f32_model = _window_gpt(torch, seed, dev, dtype=torch.float32).eval()
        full = f32_model(ids)[0]
        dev_f32 = float((_decode_logits(torch, f32_model, ids, torch.float32)[0] - full)
                        .abs().max())
        scale = float(full.abs().max())
        tol = 1e-4 * scale
        log(f"window_serve: f32 copy, decode-step logits of the {ids.shape[1]}-token request vs "
            f"the full forward (splash_attn_fwd): f32 cache max_abs_err={dev_f32:.3e} "
            f"tol={tol:.3e} (1e-4 of |logits| <= {scale:.2f})")
        if not dev_f32 <= tol:
            raise AssertionError(f"f32 decode logits with an f32 cache disagree with the "
                                 f"forward: {dev_f32} > {tol}")
        del f32_model, full

        ids = torch.from_numpy(rng.integers(0, GPT_VOCAB, (WIN_SERVE_B, WIN_L_MAX))).to(dev)
        for _ in range(WIN_WARMUP):
            model(ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        fwd_ms = []
        for _ in range(WIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {name: fn.launches for name, fn in counters.items()}
        if logits.shape != (WIN_SERVE_B, WIN_L_MAX, model.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
    peak = torch.cuda.max_memory_allocated()
    want = {name: WIN_TIMED * WIN_LAUNCHES.get(name, 0) for name in counters}
    if launches != want:
        raise AssertionError(f"{WIN_TIMED} forwards launched {launches}, expected {want}")
    med = float(np.median(fwd_ms))
    res = {"requests_s": req_s, "decode_f32_cache_max_abs_err": dev_f32, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(fwd_ms),
           "tokens_per_s": WIN_SERVE_B * WIN_L_MAX / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak}
    log(f"window_serve: B={WIN_SERVE_B} L={WIN_L_MAX} forward median {med:.2f} ms max "
        f"{max(fwd_ms):.2f} ms over {WIN_TIMED} ({res['tokens_per_s']:.0f} tokens/s), launches "
        f"{launches}, peak memory {peak / 2**30:.2f} GiB")
    return res


def phase_window_train(torch, seed, np):
    """The windowed GPT (B=8, L=2048, bf16 activations, embedding dropout
    0.1) takes WIN_TRAIN_WARMUP + WIN_TRAIN_TIMED steps of the examples/lm
    recipe on byte data, through the three splash kernels."""
    torch.manual_seed(seed)
    model = _window_gpt(torch, seed, "cuda").train()
    return _lm_train(torch, seed, np, "window_train: windowed GPT", model,
                               WIN_TRAIN_B, WIN_L_MAX, WIN_TRAIN_WARMUP, WIN_TRAIN_TIMED,
                               WIN_TRAIN_LAUNCHES)


def phase_window_parity(torch, seed, np):
    """A 2-layer f32 windowed GPT (d_model 256, 4 heads of 64, L=2048,
    W=256) on the card (splash kernels) against the CPU."""
    want = {"splash_attn_fwd": 6, "splash_attn_bwd_dkv": 4, "splash_attn_bwd_dq": 4,
            "flash_attn_fwd": 0, "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
    return _attention_lm_parity(torch, seed, np, "window_parity: 2-layer f32 windowed GPT",
                                WIN_L_MAX, want, mixer_kwargs={"window": WIN_W})


def phase_h3_train(torch, seed, np):
    """H3-125M (B=4, L=8192, bf16 activations, embedding dropout 0.1) takes
    TRAIN_WARMUP + TRAIN_TIMED steps of the examples/lm recipe on byte data."""
    torch.manual_seed(seed)
    model = _hyena_125m(torch, seed, "cuda", mixer="h3").train()
    return _lm_train(torch, seed, np, "h3_train: H3-125M", model, B, L_MAX, TRAIN_WARMUP,
                     TRAIN_TIMED, H3_TRAIN_LAUNCHES)


def _listops_batch(torch, np, seed, b, length):
    """b right-padded token ids in 1..15 (PAD 0) with lengths drawn in
    [LISTOPS_MIN_LEN, length], and b labels in 0..9."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min(LISTOPS_MIN_LEN, length), length + 1, b)
    ids = rng.integers(1, LISTOPS_VOCAB, (b, length))
    ids[np.arange(length)[None, :] >= lens[:, None]] = 0
    return torch.from_numpy(ids), torch.from_numpy(rng.integers(0, LISTOPS_CLASSES, b))


def _listops_model(torch, seed, dev, **kw):
    """The ListOps LongConvModel over token ids: one-hot over the 16 tokens
    and the pool's mask ids != PAD, as examples/lra/train_listops.py applies
    it."""
    import torch.nn.functional as F

    from flashfftconv_tpu_torch.models.long_conv import LongConvModel

    class ListOps(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = LongConvModel(
                LISTOPS_VOCAB, d_output=LISTOPS_CLASSES, **{
                    "d_model": LISTOPS_D, "n_layers": LISTOPS_LAYERS, "l_max": LISTOPS_L,
                    "dropout": 0.1, "kernel_lam": 0.001, **kw},
                device=dev, generator=torch.Generator().manual_seed(seed))

        def forward(self, ids):
            return self.model(F.one_hot(ids, LISTOPS_VOCAB).float(), mask=ids != 0)

    return ListOps()


def phase_listops_train(torch, seed, np):
    """The LRA ListOps LongConvModel at the example's defaults (B=64, 6
    layers, d_model 128, L=2048, FFT size 4096 with kernels of 4096 taps, a
    bf16 conv plan under f32 activations, dropout 0.1) takes LISTOPS_WARMUP +
    LISTOPS_TIMED steps of the example's optimizer (make_optimizer: AdamW lr
    4e-3, weight decay 0.05; the kernel-labelled parameters at lr 1e-3, no
    decay; no clip), with a 2-step warm-up in place of the example's 1000, on
    one seeded batch: a finite, falling loss and the launches of
    LISTOPS_TRAIN_LAUNCHES every step."""
    from flashfftconv_tpu_torch.utils.optim import make_optimizer
    from flashfftconv_tpu_torch.utils.train import make_train_step

    torch.manual_seed(seed)
    model = _listops_model(torch, seed, "cuda").train()
    opt, sched = make_optimizer(model.model, lr=4e-3, weight_decay=0.05, special_lr=1e-3,
                                warmup_steps=2)
    step = make_train_step(model, opt, sched, clip=math.inf)
    x, y = (t.cuda() for t in _listops_batch(torch, np, seed, LISTOPS_B, LISTOPS_L))
    counters = _counters(LISTOPS_TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, per_step = [], [], []
    for _ in range(LISTOPS_WARMUP + LISTOPS_TIMED):
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, y)["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != LISTOPS_TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {LISTOPS_TRAIN_LAUNCHES}")
    timed = step_ms[LISTOPS_WARMUP:]
    med = float(np.median(timed))
    n_params = sum(p.numel() for p in model.parameters())
    res = {"steps": len(losses), "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "step_ms_max": max(timed), "tokens_per_s": LISTOPS_B * LISTOPS_L / (med / 1e3),
           "launches": {name: fn.launches for name, fn in counters.items()},
           "peak_memory_bytes": peak, "params": n_params}
    log(f"listops_train: LongConvModel {n_params / 1e6:.3f}M params, B={LISTOPS_B} "
        f"L={LISTOPS_L} N={2 * LISTOPS_L} k_len={2 * LISTOPS_L}, {len(losses)} steps (lr 4e-3, "
        f"kernels 1e-3, wd 0.05), losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"listops_train: step median {med:.2f} ms max {max(timed):.2f} ms over {LISTOPS_TIMED} "
        f"timed steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    return res


# The 2-layer f32 LMs of mixers_parity: (options, long convs a layer). FFT
# size 2048 (Monarch kernels) but for m2 at l_max 128 (direct kernels).
MIXER_PARITY = {
    "h3": (dict(mixer="h3", l_max=1024), 2),
    "h3_shift_s4d": (dict(mixer="h3", l_max=1024, mixer_kwargs={
        "head_dim": 2, "k_kernel_type": "shift", "ssm_kernel_type": "s4d"}), 2),
    "m2": (dict(mixer="m2", l_max=128, mlp_nblocks=4), 1),
    "long_conv": (dict(mixer="long-conv", l_max=1024), 1),
}


def _check_card_vs_cpu(what, out, grads):
    """Logits within 2e-3, grads within 1e-3 of each parameter's largest |grad|."""
    err = float((out["cuda"].cpu() - out["cpu"]).abs().max())
    if set(grads["cuda"]) != set(grads["cpu"]):
        raise AssertionError(f"{what}: card and CPU grads cover other parameters")
    ratio, worst = _worst_grad(grads["cuda"], grads["cpu"])
    log(f"{what}, card (kernels) vs CPU (plain): logits max_abs_err={err:.3e} "
        f"tol=2e-3 (|logits| <= {float(out['cpu'].abs().max()):.2f}); grads max |dgrad| / max "
        f"|grad| = {ratio:.3e} ({worst}) over {len(grads['cpu'])} params, tol 1e-3")
    if not err <= 2e-3:
        raise AssertionError(f"{what}: card and CPU logits disagree: {err}")
    if not ratio <= 1e-3:
        raise AssertionError(f"{what}: card and CPU grads disagree: {worst} at {ratio}")
    return {"logits_max_abs_err": err, "grad_max_rel_err": ratio, "grad_worst_param": worst}


def phase_mixers_parity(torch, seed, np):
    """2-layer f32 LMs (d_model 128) with the h3 mixer (long-conv kernels;
    shift and s4d kernels at head_dim 2), the m2 mixer with a block-diagonal
    MLP and the long-conv mixer, then a 2-layer f32 ListOps LongConvModel
    (d_model 64, L=2048, FFT size 4096, k_len = N), each with the same
    weights on the card (kernels) and the CPU (plain versions): logits and
    every parameter's grad. Each LM's long convs launch their kernels once a
    conv forward and once backward."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    res = {}
    for what, (cfg, convs) in MIXER_PARITY.items():
        cfg = dict(cfg)
        l_max = cfg.pop("l_max")
        mk = {**cfg.pop("mixer_kwargs", {}), "conv_dtype": torch.float32}
        fwd, bwd = (("direct_conv", "direct_conv_bwd") if l_max <= 256
                    else ("monarch_conv", "monarch_conv_bwd"))
        counters = _counters((fwd, bwd))
        before = {n: fn.launches for n, fn in counters.items()}
        ids = torch.randint(0, 256, (2, l_max + 1),
                            generator=torch.Generator().manual_seed(seed + 3))
        out, grads = {}, {}
        for dev in ("cpu", "cuda"):
            model = ConvLMHeadModel(d_model=128, n_layer=2, d_inner=512, vocab_size=256,
                                    l_max=l_max, mixer_kwargs=mk, dtype=torch.float32,
                                    device=dev, generator=torch.Generator().manual_seed(seed),
                                    **cfg).eval()
            with torch.inference_mode():
                out[dev] = model(ids[:, :-1].to(dev)).float()
            grads[dev] = _loss_and_grads(torch, model, ids.to(dev))[1]
        counts = {n: fn.launches - before[n] for n, fn in counters.items()}
        want = {fwd: 2 * 2 * convs, bwd: 2 * convs}
        if counts != want:
            raise AssertionError(f"{what}: launched {counts}, expected {want}")
        res[what] = _check_card_vs_cpu(f"mixers_parity: 2-layer f32 {what} LM at l_max {l_max}",
                                       out, grads)
    x, y = _listops_batch(torch, np, seed + 4, 2, LISTOPS_L)
    out, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = _listops_model(torch, seed, dev, d_model=64, n_layers=2,
                               conv_dtype=torch.float32).eval()
        out[dev] = model(x.to(dev))
        cross_entropy(out[dev], y.to(dev)).backward()
        out[dev] = out[dev].detach()
        grads[dev] = {n: p.grad.detach() for n, p in model.named_parameters()}
    res["listops"] = _check_card_vs_cpu(f"mixers_parity: 2-layer f32 ListOps LongConvModel at "
                                        f"L={LISTOPS_L}",
                                        out, grads)
    return res


# --- the attention encoders, the MoE LM and the sparse convs --------------------

def _vit_b16(torch, seed, dev, **kw):
    """ViT-B/16 at google/vit-base-patch16-224's sizes (bf16; random weights)."""
    from flashfftconv_tpu_torch.models.vit import VisionTransformer

    cfg = dict(num_classes=VIT_CLASSES, img_size=VIT_IMG, patch_size=VIT_PATCH,
               d_model=VIT_D_MODEL, n_layer=VIT_N_LAYER, num_heads=VIT_HEADS, mlp_ratio=4,
               global_pool="token", dtype=torch.bfloat16)
    return VisionTransformer(**{**cfg, **kw}, device=dev,
                             generator=torch.Generator().manual_seed(seed))


def _images(torch, seed, b, dev, classes=VIT_CLASSES):
    """b seeded (B, 224, 224, 3) f32 images and their labels, made on dev."""
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn(b, VIT_IMG, VIT_IMG, 3, device=dev, generator=g)
    return images, torch.randint(0, classes, (b,), device=dev, generator=g)


def _timed_forwards(torch, what, fn, per_fwd, n_fwd, check):
    """n_fwd forwards of fn() under inference_mode, each timed on the host
    clock between two synchronizes; check(out) on the last; exactly per_fwd
    launches a forward. Returns (per-forward ms, launches)."""
    counters = _counters(per_fwd)
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(n_fwd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        check(out)
    launches = {name: f.launches for name, f in counters.items()}
    if launches != {name: n * n_fwd for name, n in per_fwd.items()}:
        raise AssertionError(f"{what}: {n_fwd} forwards launched {launches}, expected "
                             f"{per_fwd} each")
    return fwd_ms, launches


def phase_vit_serve(torch, seed, np):
    """ViT-B/16 classifies VIT_SERVE_B seeded images, VIT_WARMUP + VIT_TIMED
    forwards through the flash-attention forward kernel (L = 197)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = _vit_b16(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"vit_serve: ViT-B/16 {n_params / 1e6:.2f}M params, {VIT_L} tokens, built in "
        f"{time.perf_counter() - t0:.1f} s")
    images, _ = _images(torch, seed, VIT_SERVE_B, dev)
    torch.cuda.reset_peak_memory_stats()

    def check(logits):
        if logits.shape != (VIT_SERVE_B, VIT_CLASSES) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite")

    n_fwd = VIT_WARMUP + VIT_TIMED
    fwd_ms, launches = _timed_forwards(torch, "vit_serve", lambda: model(images), VIT_LAUNCHES,
                                       n_fwd, check)
    peak = torch.cuda.max_memory_allocated()
    timed = fwd_ms[VIT_WARMUP:]
    med = float(np.median(timed))
    res = {"forwards": n_fwd, "launches": launches, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(timed),
           "images_per_s": VIT_SERVE_B / (med / 1e3), "peak_memory_bytes": peak}
    log(f"vit_serve: B={VIT_SERVE_B} 224x224 bf16 (f32 attention): forward median {med:.2f} ms "
        f"max {max(timed):.2f} ms over {VIT_TIMED} timed forwards, "
        f"{res['images_per_s']:.1f} images/s, peak memory {peak / 2**30:.2f} GiB, launches a "
        f"forward {VIT_LAUNCHES}")
    del model, images
    torch.cuda.empty_cache()
    return res


def _train_loop(torch, what, step, batches, want):
    """One step a batch: a finite, falling loss and exactly the launches of
    want every step. Returns (losses, per-step ms, launches over all steps,
    peak memory)."""
    counters = _counters(want)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    losses, step_ms = [], []
    for batch in batches:
        before = {name: f.launches for name, f in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(*batch)["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        counts = {name: f.launches - before[name] for name, f in counters.items()}
        if counts != want:
            raise AssertionError(f"{what}: step {len(losses) - 1} launched {counts}, expected "
                                 f"{want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    launches = {name: f.launches for name, f in counters.items()}
    return losses, step_ms, launches, torch.cuda.max_memory_allocated()


def phase_vit_train(torch, seed, np):
    """ViT-B/16 takes VIT_TRAIN_WARMUP + VIT_TRAIN_TIMED steps at B=128
    (DeiT-B's per-GPU batch) on one seeded batch: cross entropy, clip 1.0,
    AdamW at DeiT's lr 5e-4 x B / 512 and weight decay 0.05."""
    from flashfftconv_tpu_torch.utils.train import make_train_step

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    model = _vit_b16(torch, seed, dev).train()
    lr = 5e-4 * VIT_TRAIN_B / 512
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.05)
    step = make_train_step(model, opt, None, clip=1.0)
    batch = _images(torch, seed + 1, VIT_TRAIN_B, dev)
    n_steps = VIT_TRAIN_WARMUP + VIT_TRAIN_TIMED
    losses, step_ms, launches, peak = _train_loop(torch, "vit_train", step, [batch] * n_steps,
                                                  VIT_TRAIN_LAUNCHES)
    timed = step_ms[VIT_TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "step_ms_max": max(timed), "images_per_s": VIT_TRAIN_B / (med / 1e3),
           "launches": launches, "peak_memory_bytes": peak}
    log(f"vit_train: ViT-B/16 B={VIT_TRAIN_B} bf16 (f32 attention), {n_steps} steps on one "
        f"batch (AdamW lr {lr:.3g}, wd 0.05, clip 1.0), losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    log(f"vit_train: step median {med:.2f} ms max {max(timed):.2f} ms over {VIT_TRAIN_TIMED} "
        f"timed steps ({res['images_per_s']:.1f} images/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {VIT_TRAIN_LAUNCHES}")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return res


def _parity(torch, what, build, inputs, loss_fn, want, select=None):
    """A model built on the CPU and on the card from one seed, through
    _check_card_vs_cpu: its output (``select`` picks the positions to
    compare) and every parameter's grad of loss_fn; the card's forward and
    backward launch exactly ``want``."""
    counters = _counters(want)
    out, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = build(dev).eval()
        before = {name: f.launches for name, f in counters.items()}
        y = model(*(t.to(dev) if torch.is_tensor(t) else t for t in inputs))
        loss_fn(y, dev).backward()
        out[dev] = (y if select is None else select(y)).detach().float()
        grads[dev] = {n: p.grad.detach() for n, p in model.named_parameters()
                      if p.grad is not None}
        counts = {name: f.launches - before[name] for name, f in counters.items()}
    if counts != want:
        raise AssertionError(f"{what}: the card's forward and backward launched {counts}, "
                             f"expected {want}")
    return {**_check_card_vs_cpu(what, out, grads), "launches": counts}


# The flash launches of a 2-layer attention model's forward and backward.
_FLASH_2_LAYERS = {"flash_attn_fwd": 2, "flash_attn_bwd_dkv": 2, "flash_attn_bwd_dq": 2}


def phase_vit_parity(torch, seed, np):
    """A 2-layer f32 ViT (224 x 224 images, patch 16: L = 197; d_model 256,
    4 heads of 64, 10 classes) on the card (flash kernels) and the CPU."""
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    images, labels = _images(torch, seed + 2, 2, "cpu", classes=10)
    return _parity(
        torch, "vit_parity: 2-layer f32 ViT at L=197, B=2",
        lambda dev: _vit_b16(torch, seed, dev, num_classes=10, d_model=256, n_layer=2,
                             num_heads=4, dtype=torch.float32),
        (images,), lambda y, dev: cross_entropy(y, labels.to(dev)), _FLASH_2_LAYERS)


def _padded_mlm_batch(torch, np, rng, b, length, tokens):
    """(ids, attention_mask, labels), each (b, length) int64 on the CPU:
    windows of the corpus whose row lengths are drawn in [ABERT_MIN_LEN,
    length] and whose tails are padding (id 0, mask 0); 15% of the
    positions masked (utils.data.mlm_batches), labels -100 elsewhere and on
    the pads."""
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    x, y = next(mlm_batches(tokens, b, length, rng))
    valid = np.arange(length)[None] < rng.integers(ABERT_MIN_LEN, length + 1, (b, 1))
    ids, labels = np.where(valid, x, 0), np.where(valid, y, -100)
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in (ids, valid, labels))


def _attn_bert(torch, seed, dev, **kw):
    """BertForMaskedLM at bert-base-uncased's sizes (f32; random weights)."""
    from flashfftconv_tpu_torch.models.bert import BertForMaskedLM

    cfg = dict(vocab_size=ABERT_VOCAB, d_model=BERT_D_MODEL, n_layer=BERT_N_LAYER,
               d_inner=4 * BERT_D_MODEL, num_heads=ABERT_HEADS, l_max=ABERT_L_MAX,
               type_vocab_size=2, dropout=0.1, dtype=torch.float32)
    return BertForMaskedLM(**{**cfg, **kw}, device=dev,
                           generator=torch.Generator().manual_seed(seed))


def phase_attn_bert(torch, seed, np):
    """The attention BertForMaskedLM at bert-base-uncased's sizes takes
    ABERT_WARMUP + ABERT_TIMED forwards of B=128, L=128 padded rows (lengths
    64-128, the tails masked by attention_mask) through the flash forward."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = _attn_bert(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"attn_bert: BERT-base {n_params / 1e6:.2f}M params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids, mask, labels = (t.to(dev) for t in _padded_mlm_batch(
        torch, np, np.random.default_rng(seed), BERT_B, BERT_L, _corpus(np)))
    torch.cuda.reset_peak_memory_stats()
    acc = []

    def check(logits):
        if logits.shape != (BERT_B, BERT_L, ABERT_VOCAB) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite")
        sel = labels >= 0
        acc.append(float((logits.argmax(-1)[sel] == labels[sel]).float().mean()))

    n_fwd = ABERT_WARMUP + ABERT_TIMED
    fwd_ms, launches = _timed_forwards(torch, "attn_bert", lambda: model(ids, attention_mask=mask),
                                       ABERT_LAUNCHES, n_fwd, check)
    peak = torch.cuda.max_memory_allocated()
    timed = fwd_ms[ABERT_WARMUP:]
    med = float(np.median(timed))
    n_valid = int(mask.sum())
    res = {"forwards": n_fwd, "launches": launches, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(timed),
           "tokens_per_ms": BERT_B * BERT_L / med, "valid_tokens": n_valid,
           "seqs_per_s": BERT_B / (med / 1e3), "masked_accuracy": acc[0],
           "peak_memory_bytes": peak}
    log(f"attn_bert: forward at B={BERT_B} L={BERT_L} f32 ({n_valid} valid tokens, the rest "
        f"padding): median {med:.2f} ms max {max(timed):.2f} ms over {ABERT_TIMED} timed "
        f"forwards, {res['tokens_per_ms']:.1f} tokens/ms, {res['seqs_per_s']:.1f} seqs/s, "
        f"masked top-1 accuracy {acc[0]:.4f}, peak memory {peak / 2**30:.2f} GiB, launches a "
        f"forward {ABERT_LAUNCHES}")
    del model
    torch.cuda.empty_cache()
    return res


def _attn_bert_step(torch, model):
    """bert_train's step over a padded batch: step(ids, mask, labels) runs
    the MLM loss with the attention mask, clip 1.0 and AdamW (lr 8e-4,
    weight decay 1e-5)."""
    from flashfftconv_tpu_torch.utils.train import bert_optimizer, mlm_loss

    opt = bert_optimizer(model)

    def step(ids, mask, labels):
        opt.zero_grad(set_to_none=True)
        loss, metrics = mlm_loss(model(ids, attention_mask=mask), labels)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
        opt.step()
        return {"loss": loss.detach(), **metrics}

    return step


def phase_attn_bert_train(torch, seed, np):
    """The same model takes ABERT_TRAIN_WARMUP + ABERT_TRAIN_TIMED steps of
    bert_train's recipe (clip 1.0, AdamW lr 8e-4, weight decay 1e-5, the MLM
    loss over the masked positions) at B=128, L=128 on padded rows, dropout
    0.1 (none on the attention probabilities, so the flash kernels run)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.manual_seed(seed)  # the dropout masks repeat from run to run
    model = _attn_bert(torch, seed, dev).train()
    step = _attn_bert_step(torch, model)
    rng, tokens = np.random.default_rng(seed), _corpus(np)
    n_steps = ABERT_TRAIN_WARMUP + ABERT_TRAIN_TIMED
    batches = [tuple(t.to(dev) for t in _padded_mlm_batch(torch, np, rng, BERT_B, BERT_L,
                                                           tokens)) for _ in range(n_steps)]
    losses, step_ms, launches, peak = _train_loop(torch, "attn_bert_train", step, batches,
                                                  ABERT_TRAIN_LAUNCHES)
    timed = step_ms[ABERT_TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "step_ms_max": max(timed), "tokens_per_s": BERT_B * BERT_L / (med / 1e3),
           "launches": launches, "peak_memory_bytes": peak}
    log(f"attn_bert_train: BERT-base B={BERT_B} L={BERT_L} f32, dropout 0.1, {n_steps} steps "
        f"(lr 8e-4, wd 1e-5, clip 1.0), MLM losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"attn_bert_train: step median {med:.2f} ms max {max(timed):.2f} ms over "
        f"{ABERT_TRAIN_TIMED} timed steps ({res['tokens_per_s']:.0f} tokens/s), peak memory "
        f"{peak / 2**30:.2f} GiB, launches a step {ABERT_TRAIN_LAUNCHES}")
    del model, step, batches
    torch.cuda.empty_cache()
    return res


def phase_attn_bert_parity(torch, seed, np):
    """A 2-layer f32 attention BertForMaskedLM (d_model 256, 4 heads of 64,
    vocab 300) at L=128, B=4 with padded rows, on the card (flash kernels
    with segment ids) and the CPU: logits at the valid positions, the MLM
    grads."""
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids, mask, labels = _padded_mlm_batch(torch, np, np.random.default_rng(seed + 3), 4, BERT_L,
                                          _corpus(np))
    if bool(mask.all()):
        raise AssertionError("the parity batch has no padded row")
    return _parity(
        torch, "attn_bert_parity: 2-layer f32 BERT at L=128, B=4, padded",
        lambda dev: _attn_bert(torch, seed, dev, vocab_size=300, d_model=256, n_layer=2,
                               d_inner=1024, num_heads=4, dropout=0.0),
        (ids, None, mask), lambda y, dev: cross_entropy(y, labels.to(dev), -100),
        _FLASH_2_LAYERS, select=lambda y: y[mask.to(y.device)])


def phase_moe_train(torch, seed, np):
    """Hyena-125M with MoE MLPs (MOE_KWARGS: 8 experts, top-2, capacity
    1.25) takes TRAIN_WARMUP + TRAIN_TIMED steps of the train phase's recipe
    at B=4, L=8192; reports the share of token choices dropped and the
    load-balancing loss of the last step, layer by layer."""
    from flashfftconv_tpu_torch.models.moe import MoEMlp

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    model = _hyena_125m(torch, seed, dev, moe_kwargs=MOE_KWARGS).train()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe_train: Hyena-125M with {MOE_KWARGS}: {n_params / 1e9:.3f}G params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    res = _lm_train(torch, seed, np, "moe_train: Hyena-125M MoE", model, B, L_MAX,
                    TRAIN_WARMUP, TRAIN_TIMED, TRAIN_LAUNCHES)
    moes = [m for m in model.modules() if isinstance(m, MoEMlp)]
    dropped = [1.0 - float(m.kept_fraction.sum()) / m.top_k for m in moes]
    aux = [float(m.aux_loss.detach()) for m in moes]
    if len(moes) != N_LAYER or not all(math.isfinite(a) for a in aux):
        raise AssertionError(f"{len(moes)} MoE layers, aux losses {aux}")
    res.update(params=n_params, dropped_share=dropped, aux_loss=aux,
               capacity=moes[0].capacity(B * L_MAX))
    log(f"moe_train: capacity {res['capacity']} slots an expert; the last step's share of token "
        f"choices dropped by layer {' '.join(f'{v:.4f}' for v in dropped)}; aux loss by layer "
        f"{' '.join(f'{v:.4f}' for v in aux)}")
    del model, moes
    torch.cuda.empty_cache()
    return res


def phase_moe_parity(torch, seed, np):
    """A 2-layer f32 Hyena LM with MoE MLPs (8 experts, top-2, capacity
    1.25; d_model 128, l_max 1024: the Monarch kernels at FFT size 2048) at
    B=2, L=128 (256 tokens; some drop) on the card and the CPU."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids = torch.randint(0, 256, (2, 129), generator=torch.Generator().manual_seed(seed + 5))
    want = {"monarch_conv": 2, "monarch_conv_bwd": 2, "depthwise": 2, "depthwise_bwd": 2}
    return _parity(
        torch, "moe_parity: 2-layer f32 Hyena MoE LM at L=128, B=2",
        lambda dev: ConvLMHeadModel(d_model=128, n_layer=2, d_inner=512, vocab_size=256,
                                    l_max=1024, mixer_kwargs={"conv_dtype": torch.float32},
                                    moe_kwargs=MOE_KWARGS, dtype=torch.float32, device=dev,
                                    generator=torch.Generator().manual_seed(seed)),
        (ids[:, :-1],), lambda y, dev: cross_entropy(y, ids[:, 1:].to(dev)), want)


def phase_sparse_parity(torch, seed, np):
    """partial_fft_conv on the card (a direct plan at N = 512: spectrum and
    direct_conv; a Monarch plan at N = 16384: spectrum and monarch_conv) and
    frequency_sparse_fft_conv (torch.fft, as jnp.fft in the JAX package)
    against the same calls on the CPU, f32."""
    import flashfftconv_tpu_torch as tff

    g = torch.Generator().manual_seed(seed + 6)
    res = {}
    for n, n_partial, fwd in ((512, 64, "direct_conv"), (16384, 1000, "monarch_conv")):
        x = torch.randn(4, 64, n // 2, generator=g)
        k = torch.randn(64, n // 2, generator=g) * 0.02
        counters = _counters(("spectrum", fwd))
        before = {name: f.launches for name, f in counters.items()}
        got = tff.partial_fft_conv(x.cuda(), k.cuda(), n_partial,
                                   plan=tff.make_plan(n, torch.float32, device="cuda")).cpu()
        counts = {name: f.launches - before[name] for name, f in counters.items()}
        if counts != {"spectrum": 1, fwd: 1}:
            raise AssertionError(f"partial_fft_conv at N={n} launched {counts}")
        ref = tff.partial_fft_conv(x, k, n_partial,
                                   plan=tff.make_plan(n, torch.float32, device="cpu"))
        res[f"partial@{n}"] = compare(f"sparse_parity: partial_fft_conv N={n} n_partial="
                                      f"{n_partial} ({fwd}) card vs CPU", got, ref, f32_tol(ref))
    x, k = torch.randn(4, 64, 2048, generator=g), torch.randn(64, 2048, generator=g) * 0.02
    ref = tff.frequency_sparse_fft_conv(x, k, 512)
    res["frequency_sparse"] = compare(
        "sparse_parity: frequency_sparse_fft_conv L=2048 n_partial=512 card vs CPU",
        tff.frequency_sparse_fft_conv(x.cuda(), k.cuda(), 512).cpu(), ref, f32_tol(ref))
    return res


# The one-block conv kernels the torch CLIs' paths launch, counted in the CLI's
# own process (_COUNTED_RUN).
CLI_KERNELS = ("spectrum", "monarch_conv", "monarch_conv_bwd", "dk_finish", "depthwise",
               "depthwise_bwd", "direct_conv", "direct_conv_bwd", "butterfly", "long_conv",
               "long_spectrum", "long_conv_bwd", "long_dk_finish")
# Runs ``python <script> <args>`` as its user would, with the launch counters
# of CLI_KERNELS set to 0 first, and prints their counts on a line of its own
# when the script ends.
_COUNTED_RUN = """import json, runpy, sys
sys.path.insert(0, {here!r})
import chip_smoke
fns = chip_smoke._counters(chip_smoke.CLI_KERNELS)
for fn in fns.values():
    fn.launches = 0
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    print("LAUNCHES " + json.dumps({{n: fn.launches for n, fn in fns.items()}}), flush=True)
"""
HARNESS_STEPS = 4
HARNESS_EVAL_ROWS, HARNESS_EVAL_B = 1000, 64
LM_CLI_STEPS, LM_CLI_RESUMED = 6, 8
# The other eight torch CLIs at the arguments of their JAX scripts' smoke tests
# (tests/test_examples.py; ListOps with --min-len 16, since its default of 500
# is above --l-max 256; seqcls, which has none, at one epoch of 2 batches over
# 64 fragments a class), with the marker each must print and a kernel each
# must launch: FFT size 1024 for HyenaDNA (Monarch), 256 and 512 for
# BERT, ListOps, retrieval and ETT (direct), 2048 for Pathfinder, seqcls and
# CIFAR (L = 1024, Monarch).
CLI_SMOKE = {
    "hyena_dna": ("examples/hyena_dna/train_torch.py",
                  ["--steps", "2", "--d_model", "32", "--n_layer", "1", "--l_max", "512"],
                  "bits/base", "monarch_conv_bwd"),
    "bert": ("examples/bert/train_torch.py",
             ["--steps", "3", "--d_model", "32", "--n_layer", "1", "--batch_size", "4"],
             "mlm loss", "direct_conv_bwd"),
    "listops": ("examples/lra/train_listops_torch.py",
                ["--epochs", "1", "--n-train", "64", "--n-val", "32", "--batch_size", "32",
                 "--l-max", "256", "--min-len", "16", "--d_model", "32", "--n_layers", "1",
                 "--data-cache", "{tmp}/listops.npz", "--ckpt-dir", "{tmp}/listops_ckpt"],
                "val acc", "direct_conv_bwd"),
    "retrieval": ("examples/lra/train_retrieval_torch.py",
                  ["--epochs", "1", "--n-train", "64", "--n-val", "32", "--batch_size", "16",
                   "--l-max", "256", "--d_model", "32", "--n_layers", "1",
                   "--data-cache", "{tmp}/retrieval.npz", "--ckpt-dir", "{tmp}/retrieval_ckpt"],
                  "val acc", "direct_conv_bwd"),
    "forecasting": ("examples/forecasting/train_ett_torch.py",
                    ["--epochs", "1", "--n-steps", "2000", "--l-max", "256", "--horizon", "24",
                     "--batch_size", "16", "--d_model", "32", "--n_layers", "1",
                     "--ckpt-dir", "{tmp}/ett_ckpt"],
                    "val mse", "direct_conv_bwd"),
    "pathfinder": ("examples/lra/train_pathfinder_torch.py",
                   ["--epochs", "1", "--n-train", "64", "--n-val", "32", "--batch_size", "32",
                    "--d_model", "32", "--n_layers", "1",
                    "--data-cache", "{tmp}/pathfinder.npz", "--ckpt-dir", "{tmp}/pf_ckpt"],
                   "val acc", "monarch_conv_bwd"),
    "seqcls": ("examples/seqcls/train_torch.py",
               ["--epochs", "1", "--per-class", "64", "--limit-batches", "2", "--d_model", "32",
                "--n_layers", "1", "--data-cache", "{tmp}/seqcls.npz",
                "--ckpt-dir", "{tmp}/seqcls_ckpt"],
               "val acc", "monarch_conv_bwd"),
    "cifar": ("examples/cifar/train_torch.py",
              ["--epochs", "1", "--synthetic", "--d_model", "32", "--n_layers", "1",
               "--batch_size", "32", "--limit-batches", "2", "--ckpt-dir", "{tmp}/cifar_ckpt"],
              "val acc", "monarch_conv_bwd"),
}
# The ultra-long CLI's 2M-token context: N = 4,194,304 on a 1-rank sp mesh,
# each long conv four real convs through the long ladder.
ULTRA_L, ULTRA_STEPS = 2_097_152, 3
ULTRA_KERNELS = ("butterfly", "long_conv", "long_spectrum", "long_conv_bwd")
# parallel_train's ChunkedMlp check: HyenaDNA's memory lever (mlp_l_chunks=4)
PARALLEL_L_CHUNKS = 4
# parallel_train's pipeline: the first PIPE_LAYERS Hyena-125M blocks, in
# f32, as one stage of a 1-rank pp mesh, over PIPE_M microbatches.
PIPE_LAYERS, PIPE_M = 2, 4


def _dir_gib(path) -> float:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file()) / 2**30


def phase_harness(torch, seed, np):
    """The training harness at Hyena-125M's full width, in process: the model
    from the registry, HARNESS_STEPS steps of the train recipe with a
    checkpoint after the first two, then a fresh model (other initial
    weights) restored from it takes the last two: the losses and every
    parameter must be bit-identical. Then an auto-save under a raised error
    and latest_checkpoint, debug_nans on a NaN made on the card, evaluate on
    the ListOps LongConvModel over 1000 rows at B=64 against a row-by-row
    count, and the native loader's restore."""
    import tempfile

    from flashfftconv_tpu_torch.utils import debugging, native_loader, registry
    from flashfftconv_tpu_torch.utils.train import (
        auto_save_on_exception,
        create_train_state,
        evaluate,
        latest_checkpoint,
        lm_optimizer,
        make_eval_step,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = {"_name_": "lm", "d_model": D_MODEL, "n_layer": N_LAYER, "d_inner": 4 * D_MODEL,
           "vocab_size": VOCAB, "mixer": "hyena"}

    def build(init_seed):
        model = registry.instantiate("model", cfg, l_max=L_MAX, dtype=torch.bfloat16,
                                     device=dev,
                                     generator=torch.Generator().manual_seed(init_seed)).train()
        opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2,
                                  steps=HARNESS_STEPS)
        return create_train_state(model, opt, sched), make_train_step(model, opt, sched,
                                                                      clip=1.0)

    def run(state, step, batches):
        losses = []
        for x, y in batches:
            torch.manual_seed((seed << 32) + state.step)  # dropout masks of this step
            losses.append(float(step(x, y)["loss"]))
            state.step += 1
        return losses

    batches = _train_batches(torch, np, seed, dev, HARNESS_STEPS)
    half = HARNESS_STEPS // 2
    counters = _counters(TRAIN_LAUNCHES)
    for fn in counters.values():
        fn.launches = 0
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        last = Path(tmp) / "last"
        state, step = build(seed)
        first = run(state, step, batches[:half])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(last), state, {"step": state.step})
        res["save_s"] = time.perf_counter() - t0
        res["checkpoint_gib"] = _dir_gib(last)
        want = run(state, step, batches[half:])
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        del state, step
        torch.cuda.empty_cache()

        fresh, fresh_step = build(seed + 1)
        t0 = time.perf_counter()
        fresh, extra = restore_checkpoint(str(last), fresh, {"step": 0})
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t0
        if extra != {"step": half} or fresh.step != half:
            raise AssertionError(f"harness: restored extra {extra}, step {fresh.step}")
        got = run(fresh, fresh_step, batches[half:])
        if got != want:
            raise AssertionError(f"harness: resumed losses {got} != uninterrupted {want}")
        differ = [n for n, p in fresh.model.named_parameters() if not torch.equal(p, params[n])]
        if differ:
            raise AssertionError(f"harness: parameters differ after the resumed steps: {differ}")
        res["losses"] = first + want
        res["params_checked"] = len(params)
        launches = {name: fn.launches for name, fn in counters.items()}
        expected = {name: n * (HARNESS_STEPS + half) for name, n in TRAIN_LAUNCHES.items()}
        if launches != expected:
            raise AssertionError(f"harness: launched {launches}, expected {expected}")
        res["launches"] = launches

        guard = auto_save_on_exception(tmp)
        t0 = time.perf_counter()
        try:
            with guard:
                guard.track(fresh, extra={"step": fresh.step})
                raise RuntimeError("a deliberate failure")
        except RuntimeError as e:
            if str(e) != "a deliberate failure":
                raise
        res["auto_save_s"] = time.perf_counter() - t0
        if latest_checkpoint(tmp) != guard.path:
            raise AssertionError(f"harness: latest_checkpoint {latest_checkpoint(tmp)}, "
                                 f"not the auto-save {guard.path}")
        del fresh, fresh_step, params
        torch.cuda.empty_cache()

    try:
        with debugging.debug_nans():
            torch.log(torch.full((4,), -1.0, device=dev))
        raise AssertionError("harness: debug_nans let a NaN made on the card through")
    except FloatingPointError as e:
        res["debug_nans"] = str(e)

    model = _listops_model(torch, seed, dev)
    ids, labels = (t.numpy() for t in _listops_batch(torch, np, seed + 1, HARNESS_EVAL_ROWS,
                                                    LISTOPS_L))
    correct, total = evaluate(make_eval_step(model), (ids, labels), HARNESS_EVAL_B, dev)
    model.eval()
    ref = 0
    with torch.no_grad():
        for i in range(0, len(ids), HARNESS_EVAL_B):
            rows = torch.zeros((HARNESS_EVAL_B, LISTOPS_L), dtype=torch.long, device=dev)
            chunk = torch.from_numpy(ids[i : i + HARNESS_EVAL_B]).to(dev)
            rows[: len(chunk)] = chunk  # pad rows are all PAD here, copies in evaluate
            pred = model(rows)[: len(chunk)].argmax(-1).cpu().numpy()
            ref += int((pred == labels[i : i + HARNESS_EVAL_B]).sum())
    if total != HARNESS_EVAL_ROWS or correct != ref:
        raise AssertionError(f"harness: evaluate gave ({correct}, {total}), the rows count "
                             f"({ref}, {HARNESS_EVAL_ROWS})")
    res["evaluate"] = {"correct": correct, "total": total}
    del model

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tokens.bin"
        _corpus(np).astype(np.uint8).tofile(path)
        loader = native_loader.NativeLMLoader(str(path), B, L_MAX, seed=seed)
        try:
            for _ in range(3):
                loader.next()
            counter = loader.state()
            ahead = [loader.next() for _ in range(2)]
            loader.restore(counter)
            again = [loader.next() for _ in range(2)]
        finally:
            loader.close()
        if counter != 3 or not all((a == b).all() for pa, pb in zip(ahead, again)
                                   for a, b in zip(pa, pb)):
            raise AssertionError(f"harness: the native loader did not resume at {counter}")
    log(f"harness: Hyena-125M from the registry, {HARNESS_STEPS} steps, losses "
        f"{' '.join(f'{v:.6f}' for v in res['losses'])}; resumed from the checkpoint of step "
        f"{half}: losses and {res['params_checked']} parameters bit-identical")
    log(f"harness: checkpoint {res['checkpoint_gib']:.3f} GiB, save {res['save_s']:.2f} s, "
        f"restore {res['restore_s']:.2f} s, auto-save {res['auto_save_s']:.2f} s; "
        f"debug_nans: {res['debug_nans']}; evaluate ListOps {correct:.0f}/{total:.0f} at "
        f"B={HARNESS_EVAL_B} (rows count {ref}); native loader resumed at batch {counter}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"harness: {res['seconds']:.1f} s")
    return res


def _run_cli(script, args, timeout):
    """Run a torch CLI in a subprocess through _COUNTED_RUN: (rc, stdout,
    stderr, seconds, launches of CLI_KERNELS)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _COUNTED_RUN.format(here=str(HERE)), script,
                           *args], cwd=HERE, capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    launches = {}
    for line in proc.stdout.splitlines():
        if line.startswith("LAUNCHES "):
            launches = json.loads(line[len("LAUNCHES "):])
    return proc.returncode, proc.stdout, proc.stderr, seconds, launches


def _cli_failed(what, rc, out, err, why):
    return AssertionError(f"{what}: {why} (rc {rc})\n--- stdout\n{out[-3000:]}\n"
                          f"--- stderr\n{err[-3000:]}")


def phase_lm_cli(torch, np, train=None):
    """examples/lm/train_torch.py --preset hyena-125M on the pystdlib corpus
    (built from this machine's Python standard library), as a user runs it:
    LM_CLI_STEPS steps with an eval every 3, a checkpoint at the end, then
    --resume to LM_CLI_RESUMED. Requires the native loader, the resume at
    step 6, finite val bits/byte, a sample, one JSONL record per step and
    each step's kernel launches; prints the median step time, tokens/s and
    peak memory beside the train phase's (``train``) for the same model, B
    and L."""
    import gc
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    res = {"runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        log_file = Path(tmp) / "lm.jsonl"
        common = ["--preset", "hyena-125M", "--data", "pystdlib", "--eval-every", "3",
                  "--log-every", "1", "--time-steps", "--ckpt-dir", f"{tmp}/ckpt",
                  "--log-file", str(log_file)]
        for steps, extra, done in ((LM_CLI_STEPS, [], 0),
                                   (LM_CLI_RESUMED, ["--resume"], LM_CLI_STEPS)):
            rc, out, err, seconds, launches = _run_cli("examples/lm/train_torch.py",
                                                       common + ["--steps", str(steps), *extra],
                                                       timeout=600)
            what = f"lm_cli run to step {steps}"
            if rc != 0:
                raise _cli_failed(what, rc, out, err, "failed")
            for marker in ("using native C++ dataloader", "sample:", "bits/byte",
                           *([f"resumed at step {done}"] if done else [])):
                if marker not in out:
                    raise _cli_failed(what, rc, out, err, f"no {marker!r} in its output")
            n = steps - done
            for name, per_step in TRAIN_LAUNCHES.items():
                backward = name in ("monarch_conv_bwd", "dk_finish", "depthwise_bwd")
                # backward kernels run in the steps alone; forward ones also in
                # the evals and the 32 forwards of the sample
                if launches.get(name, 0) < n * per_step or (backward and
                                                            launches[name] != n * per_step):
                    raise _cli_failed(what, rc, out, err, f"launched {launches}, {n} steps "
                                      f"need {TRAIN_LAUNCHES} a step")
            peak = re.search(r"train-step peak memory: (\d+) MB", out)
            res["runs"].append({"steps": steps, "seconds": seconds, "launches": launches,
                                "peak_memory_mb": int(peak.group(1)) if peak else None,
                                "sample": out.split("sample:", 1)[1].splitlines()[0].strip()})
        records = [json.loads(line) for line in log_file.read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_bits_per_byte" in r]
    if [r["step"] for r in steps] != list(range(LM_CLI_RESUMED)):
        raise AssertionError(f"lm_cli: step records {[r['step'] for r in steps]}")
    if not vals or not all(math.isfinite(r["val_bits_per_byte"]) for r in vals):
        raise AssertionError(f"lm_cli: val records {vals}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        raise AssertionError(f"lm_cli: losses {[r['loss'] for r in steps]}")
    # the first step of each process builds and warms up; the rest are timed
    timed = [r["step_ms"] for r in steps if r["step"] not in (0, LM_CLI_STEPS)]
    med = float(np.median(timed))
    peak_gib = max(r["peak_memory_mb"] for r in res["runs"]) / 1024
    res.update(losses=[r["loss"] for r in steps], step_ms=[r["step_ms"] for r in steps],
               step_ms_median=med, tokens_per_s=B * L_MAX / (med / 1e3),
               peak_memory_gib=peak_gib,
               val_bits_per_byte=[(r["step"], r["val_bits_per_byte"]) for r in vals])
    vals_txt = " ".join(f"{s}:{v:.4f}" for s, v in res["val_bits_per_byte"])
    secs = " + ".join(f"{r['seconds']:.1f}" for r in res["runs"])
    log(f"lm_cli: examples/lm/train_torch.py --preset hyena-125M --data pystdlib, "
        f"{LM_CLI_STEPS} steps then --resume to {LM_CLI_RESUMED}: losses "
        f"{' '.join(f'{v:.4f}' for v in res['losses'])}, val bits/byte "
        f"{vals_txt}, {secs} s of command")
    beside = (f"train phase {train['step_ms_median']:.2f} ms, {train['tokens_per_s']:.0f} "
              f"tokens/s, peak {train['peak_memory_bytes'] / 2**30:.2f} GiB" if train
              else "train phase not run")
    log(f"lm_cli: step median {med:.2f} ms over {len(timed)} timed steps "
        f"({res['tokens_per_s']:.0f} tokens/s), peak memory {peak_gib:.2f} GiB; {beside}; "
        f"sample {res['runs'][-1]['sample']}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"lm_cli: {res['seconds']:.1f} s")
    return res


def phase_cli_smoke(torch):
    """The other five torch CLIs on the card at their JAX smoke tests'
    arguments (CLI_SMOKE), all started together: each must exit 0, print its
    marker and launch its kernel."""
    import gc
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(CLI_SMOKE)) as pool:
        futures = {name: pool.submit(_run_cli, script, [a.format(tmp=tmp) for a in args], 600)
                   for name, (script, args, _, _) in CLI_SMOKE.items()}
        for name, (script, _, marker, kernel) in CLI_SMOKE.items():
            rc, out, err, seconds, launches = futures[name].result()
            if rc != 0 or marker not in out or not launches.get(kernel):
                raise _cli_failed(f"cli_smoke {script}", rc, out, err,
                                  f"marker {marker!r}, launches {launches}")
            res[name] = {"seconds": seconds, "launches": launches}
            launched = {k: v for k, v in launches.items() if v}
            log(f"cli_smoke: {script} {seconds:.1f} s, {marker!r} printed, launches {launched}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"cli_smoke: {res['seconds']:.1f} s for the {len(CLI_SMOKE)} together")
    return res


def _parallel_mesh(torch, names):
    """A 1 x 1 mesh of the named dimensions over the card's 1-rank NCCL group."""
    from flashfftconv_tpu_torch.parallel.mesh import make_mesh

    _seq_mesh(torch)  # the process group
    if names not in _MESH:
        _MESH[names] = make_mesh((1,) * len(names), names, device="cuda")
    return _MESH[names]


def _parallel_lm(torch, seed, dev, mesh, dtype=None, **kw):
    """Hyena-125M (``kw`` to the model) with its parameters placed by
    param_shardings on ``mesh``, and its train step:
    vocab_parallel_cross_entropy over tp, ZeRO-1 moments and ZeRO-2 grads
    over dp, the train phase's recipe."""
    from flashfftconv_tpu_torch.ops.fused import vocab_parallel_cross_entropy
    from flashfftconv_tpu_torch.parallel.comm import scatter_to
    from flashfftconv_tpu_torch.parallel.mesh import (
        param_shardings,
        shard_parameters,
        zero1_shardings,
        zero2_shardings,
    )
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    model = _hyena_125m(torch, seed, dev, dtype=dtype, **kw).train()
    shard_parameters(model, param_shardings(mesh, model))
    tp = mesh.get_group("tp")
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2,
                              steps=TRAIN_WARMUP + TRAIN_TIMED)
    step = make_train_step(
        model, opt, sched, clip=1.0,
        loss_fn=lambda logits, y: vocab_parallel_cross_entropy(scatter_to(logits, -1, tp), y,
                                                               mesh, "tp"),
        opt_shardings=zero1_shardings(mesh, model), grad_shardings=zero2_shardings(mesh, model))
    return model, step


def _parallel_route_f32(torch, seed, dev, mesh, x, y, **kw):
    """Hyena-125M in f32 activations (``kw`` to the model), dropout on, one
    step of the parallel train step on (x, y) against one backward of the
    plain model on the same weights and dropout mask: (loss relative error,
    (worst grad error over max |grad|, parameter), the number of MLPs whose
    fc1 runs tensor-parallel); the parallel grads read before the clip."""
    from flashfftconv_tpu_torch.models.lm import Mlp
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    model = _hyena_125m(torch, seed, dev, dtype=torch.float32, **kw).train()
    torch.manual_seed(seed)
    ref_loss = cross_entropy(model(x), y)
    ref_loss.backward()
    ref = {n: p.grad for n, p in model.named_parameters()}
    ref_loss = float(ref_loss.detach())
    del model
    torch.cuda.empty_cache()
    model, step = _parallel_lm(torch, seed, dev, mesh, dtype=torch.float32, **kw)
    tp_mlps = sum(isinstance(m, Mlp) and m.fc1.tp is not None for m in model.modules())
    torch.manual_seed(seed)
    out = step(x, y)
    unclip = max(1.0, float(out["grad_norm"]) + 1e-6)  # grad * min(1, 1 / (norm + 1e-6))
    worst = _worst_rel({n: p.grad * unclip for n, p in model.named_parameters()}, ref)
    loss_err = abs(float(out["loss"]) - ref_loss) / abs(ref_loss)
    del model, step, ref
    torch.cuda.empty_cache()
    return loss_err, worst, tp_mlps


def _pipeline_check(torch, seed, dev, mesh, g):
    """pipeline_apply on a 1-rank pp mesh, PIPE_M microbatches, over the
    first PIPE_LAYERS Hyena-125M blocks in f32 (one stage) against the plain
    blocks on the same input: the output at 1e-5 of its largest |value|, the
    grads of a random projection of it at 1e-3 of each one's largest |grad|."""
    from torch.func import functional_call

    from flashfftconv_tpu_torch.models.lm import Block
    from flashfftconv_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        stack_stage_params,
        stage_param_shardings,
    )

    gen = torch.Generator().manual_seed(seed)
    stage = torch.nn.Sequential(*(Block(D_MODEL, 4 * D_MODEL, mixer="hyena",
                                        mixer_kwargs={"l_max": L_MAX}, device=dev,
                                        generator=gen) for _ in range(PIPE_LAYERS))).eval()
    x = torch.randn(B, L_MAX, D_MODEL, generator=g).to(dev)
    dy = torch.randn(B, L_MAX, D_MODEL, generator=g).to(dev)
    y_ref = stage(x)
    (y_ref * dy).sum().backward()
    ref = {n: p.grad.clone() for n, p in stage.named_parameters()}
    stacked = stack_stage_params([{n: p.detach() for n, p in stage.named_parameters()}])
    local = {n: sh.local(stacked[n]).requires_grad_()
             for n, sh in stage_param_shardings(mesh, stacked).items()}
    y = pipeline_apply(lambda p, h: functional_call(stage, p, (h,)), local, x, mesh,
                       num_microbatches=PIPE_M)
    (y * dy).sum().backward()
    y_err = float((y - y_ref).detach().abs().max() / y_ref.detach().abs().max())
    grad_err = _worst_rel({n: t.grad[0] for n, t in local.items()}, ref)
    log(f"parallel_train: pipeline_apply, {PIPE_LAYERS} Hyena-125M blocks f32 on a 1-rank pp "
        f"mesh, M={PIPE_M}, B={B}, L={L_MAX}: max |dy| / max |y| {y_err:.3e} (tol 1e-5), max "
        f"|dgrad| / max |grad| {grad_err[0]:.3e} ({grad_err[1]}, tol 1e-3)")
    if not (y_err <= 1e-5 and grad_err[0] <= 1e-3):
        raise AssertionError(f"pipelined blocks disagree: {y_err}, {grad_err}")
    del stage, local, y, y_ref, ref
    torch.cuda.empty_cache()
    return {"y_rel_err": y_err, "grad_rel_err": grad_err[0], "grad_worst_param": grad_err[1]}


def _moe_ep_check(torch, seed, dev, mesh):
    """moe_parity's 2-layer f32 Hyena MoE LM (8 experts, top-2) with its
    experts on a 1 x 1 (dp, ep) mesh (moe_param_shardings) against the same
    LM without a mesh, on the card: logits and every grad at 1e-5 of their
    largest |value|."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.models.moe import moe_param_shardings
    from flashfftconv_tpu_torch.parallel.mesh import shard_parameters
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    ids = torch.randint(0, 256, (2, 129), generator=torch.Generator().manual_seed(seed + 5))
    ids = ids.to(dev)
    out = []
    for kw in ({}, {"ep_axis": "ep", "mesh": mesh}):
        model = ConvLMHeadModel(d_model=128, n_layer=2, d_inner=512, vocab_size=256,
                                l_max=1024, mixer_kwargs={"conv_dtype": torch.float32},
                                moe_kwargs={**MOE_KWARGS, **kw}, dtype=torch.float32,
                                device=dev, generator=torch.Generator().manual_seed(seed)).eval()
        if kw:
            shard_parameters(model, moe_param_shardings(mesh, model))
        y = model(ids[:, :-1])
        cross_entropy(y, ids[:, 1:]).backward()
        out.append((y.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (y_ref, ref), (y, grads) = out
    y_err = float((y - y_ref).abs().max() / y_ref.abs().max())
    grad_err = _worst_rel(grads, ref)
    log(f"parallel_train: MoEMlp(ep_axis='ep') on a 1 x 1 (dp, ep) mesh vs the one-device "
        f"MoE LM of moe_parity: max |dlogits| / max |logits| {y_err:.3e}, max |dgrad| / max "
        f"|grad| {grad_err[0]:.3e} ({grad_err[1]}), tol 1e-5")
    if not (y_err <= 1e-5 and grad_err[0] <= 1e-5):
        raise AssertionError(f"MoE on the ep mesh disagrees: {y_err}, {grad_err}")
    return {"logits_rel_err": y_err, "grad_rel_err": grad_err[0]}


def phase_parallel_train(torch, seed, np, train=None):
    """The parallel layer at Hyena-125M's full width and the train phase's
    recipe, on 1 x 1 meshes of the card's 1-rank NCCL group: parameters by
    param_shardings on (dp, tp), ZeRO-1 moments and ZeRO-2 grads over dp
    through make_train_step, the loss by vocab_parallel_cross_entropy over
    tp. In f32 activations, dropout on, the first batch: loss within 1e-3
    relative and grads (before the clip) within 1e-3 of each parameter's
    largest |grad| of the plain model's; the same for the model with
    mlp_l_chunks=PARALLEL_L_CHUNKS, whose ChunkedMlp runs its
    tensor-parallel form in every layer, against the plain chunked model
    (the Hyena kernels under both). Then pipeline_apply (_pipeline_check)
    and the MoE experts on an ep mesh (_moe_ep_check). Then the bf16 model
    takes TRAIN_WARMUP + TRAIN_TIMED steps of the train phase's batches: its
    first loss within 1e-3 of the plain model's on the same batch, weights
    and dropout mask, each step launching TRAIN_LAUNCHES; the median step
    and peak memory beside the train phase's."""
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    mesh = _parallel_mesh(torch, ("dp", "tp"))
    batches = _train_batches(torch, np, seed, dev, TRAIN_WARMUP + TRAIN_TIMED)
    x0, y0 = batches[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss_err, grad_err, _ = _parallel_route_f32(torch, seed, dev, mesh, x0, y0)
    log(f"parallel_train: f32, B={B}, dropout on, (dp, tp) = (1, 1) step vs the plain model: "
        f"loss rel err {loss_err:.3e} (tol 1e-3), max |dgrad| / max |grad| {grad_err[0]:.3e} "
        f"({grad_err[1]}), tol 1e-3; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (loss_err <= 1e-3 and grad_err[0] <= 1e-3):
        raise AssertionError(f"f32 parallel step disagrees: {loss_err}, {grad_err}")
    torch.cuda.reset_peak_memory_stats()
    chunk_loss, chunk_grad, tp_mlps = _parallel_route_f32(torch, seed, dev, mesh, x0, y0,
                                                          mlp_l_chunks=PARALLEL_L_CHUNKS)
    log(f"parallel_train: f32, mlp_l_chunks={PARALLEL_L_CHUNKS}, ChunkedMlp tensor-parallel in "
        f"{tp_mlps} of {N_LAYER} layers, (dp, tp) = (1, 1) step vs the plain chunked model: "
        f"loss rel err {chunk_loss:.3e} (tol 1e-3), max |dgrad| / max |grad| "
        f"{chunk_grad[0]:.3e} ({chunk_grad[1]}), tol 1e-3; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (chunk_loss <= 1e-3 and chunk_grad[0] <= 1e-3 and tp_mlps == N_LAYER):
        raise AssertionError(f"chunked tp step disagrees: {chunk_loss}, {chunk_grad}, "
                             f"{tp_mlps} tp MLPs")
    g = torch.Generator().manual_seed(seed + 7)
    pipe = _pipeline_check(torch, seed, dev, _parallel_mesh(torch, ("pp",)), g)
    moe = _moe_ep_check(torch, seed, dev, _parallel_mesh(torch, ("dp", "ep")))

    ref = _hyena_125m(torch, seed, dev).train()
    torch.manual_seed(seed)
    with torch.no_grad():
        ref_loss = float(cross_entropy(ref(x0), y0))
    del ref
    torch.cuda.empty_cache()
    model, step = _parallel_lm(torch, seed, dev, mesh)
    counters = _counters(TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    torch.manual_seed(seed)
    losses, step_ms, per_step = [], [], []
    for x, y in batches:
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(x, y)["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    first_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    timed = step_ms[TRAIN_WARMUP:]
    med = float(np.median(timed))
    log(f"parallel_train: Hyena-125M B={B} L={L_MAX} bf16 on (dp, tp) = (1, 1), ZeRO-2, "
        f"vocab-parallel loss: losses {' '.join(f'{v:.4f}' for v in losses)}; first vs the "
        f"plain model {ref_loss:.6f} (rel err {first_err:.3e}, tol 1e-3)")
    beside = (f"train phase {train['step_ms_median']:.2f} ms, peak "
              f"{train['peak_memory_bytes'] / 2**30:.2f} GiB" if train else "train phase not run")
    log(f"parallel_train: step median {med:.2f} ms max {max(timed):.2f} ms over {TRAIN_TIMED} "
        f"timed steps ({B * L_MAX / (med / 1e3):.0f} tokens/s), peak memory "
        f"{peak / 2**30:.2f} GiB; {beside}; launches a step {per_step[-1]}")
    if not first_err <= 1e-3:
        raise AssertionError(f"parallel_train first loss {losses[0]} != plain {ref_loss}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"parallel_train losses {losses}")
    for i, counts in enumerate(per_step):
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {TRAIN_LAUNCHES}")
    del model, step
    torch.cuda.empty_cache()
    res = {"f32_loss_rel_err": loss_err, "f32_grad_max_rel_err": grad_err[0],
           "f32_grad_worst_param": grad_err[1],
           "chunked_tp": {"loss_rel_err": chunk_loss, "grad_max_rel_err": chunk_grad[0],
                          "grad_worst_param": chunk_grad[1], "tp_mlps": tp_mlps},
           "pipeline": pipe, "moe_ep": moe,
           "losses": losses, "first_loss_rel_err": first_err, "step_ms": step_ms,
           "step_ms_median": med, "step_ms_max": max(timed),
           "tokens_per_s": B * L_MAX / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak, "seconds": time.perf_counter() - t_phase}
    log(f"parallel_train: {res['seconds']:.1f} s")
    return res


def phase_ultra_long_cli(torch, np):
    """examples/seq_parallel/train_ultra_long_torch.py --l-max ULTRA_L --steps
    ULTRA_STEPS as its user runs it (its defaults: d_model 32, 2 layers,
    order 2, filter_order 16, f32 conv, vocab 64, B=1) on a 1-rank sp mesh:
    a 2,097,152-token context at FFT size 4,194,304. It must exit 0, print
    its final loss and launch each of ULTRA_KERNELS; reports its steps'
    times and peak memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    script = "examples/seq_parallel/train_ultra_long_torch.py"
    rc, out, err, seconds, launches = _run_cli(
        script, ["--l-max", str(ULTRA_L), "--steps", str(ULTRA_STEPS)], timeout=600)
    if rc != 0 or "final loss" not in out or not all(launches.get(k) for k in ULTRA_KERNELS):
        raise _cli_failed(f"ultra_long_cli {script}", rc, out, err,
                          f"launches {launches}, need {ULTRA_KERNELS}")
    step_s = [float(v) for v in re.findall(r"step \d+: loss [\d.]+ \(([\d.]+)s", out)]
    losses = [float(v) for v in re.findall(r"step \d+: loss ([\d.]+)", out)]
    peak = re.search(r"peak memory: ([\d.]+) GiB", out)
    res = {"seconds": seconds, "launches": launches, "step_s": step_s, "losses": losses,
           "step_s_median_after_first": float(np.median(step_s[1:])),
           "peak_memory_gib": float(peak.group(1)) if peak else None}
    launched = {k: v for k, v in launches.items() if v}
    log(f"ultra_long_cli: {script} --l-max {ULTRA_L} --steps {ULTRA_STEPS}: losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}, steps {' '.join(f'{v:.2f}' for v in step_s)} s "
        f"(median after the first {res['step_s_median_after_first']:.3f} s), peak memory "
        f"{res['peak_memory_gib']} GiB, {seconds:.1f} s of command, launches {launched}")
    return res

def phase_smem_probe(torch, seed):
    """The shared-memory probe (utils.smem_probe.run_probe): the sweep of
    KB_GRID with smem_probe_touch, 4.0 at every size that launched, the
    largest working size equal to the opt-in attribute on the grid, a second
    launch at it, then smem_copy over 256 MiB of f32 at 16 KB, 64 KB and the
    largest tile, each bit for bit with x * 1.0001 and timed beside
    torch.mul."""
    from flashfftconv_tpu_torch.utils import smem_probe as sp

    counters = _counters(("smem_probe_touch", "smem_copy"))
    for fn in counters.values():
        fn.launches = 0
    res = sp.run_probe("cuda", seed=seed, log=log)
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    if not all(res["launches"].values()):
        raise AssertionError(f"a probe kernel never launched: {res['launches']}")
    return res


def _kind(name: str) -> str:
    for kind, keys in (
        ("butterfly", ("butterfly_fwd_kernel", "butterfly_inv_kernel")),
        ("long_conv_bwd", ("long_conv_bwd_kernel",)),
        ("long_dk_finish", ("long_dk_finish_kernel",)),
        ("long_conv", ("long_conv_kernel",)),
        ("long_spectrum", ("band_split_kernel", "bands_to_natural_kernel")),
        ("band_conv", ("band_conv_kernel",)),
        ("flash_attn_bwd_dkv", ("flash_attn_bwd_dkv_kernel",)),
        ("flash_attn_bwd_dq", ("flash_attn_bwd_dq_kernel",)),
        ("flash_attn_fwd", ("flash_attn_fwd_kernel",)),
        ("splash_attn_bwd_dkv", ("splash_attn_bwd_dkv_kernel",)),
        ("splash_attn_bwd_dq", ("splash_attn_bwd_dq_kernel",)),
        ("splash_attn_fwd", ("splash_attn_fwd_kernel",)),
        # the row-FFT backward's direct instances (N <= 512: log2 M <= 8)
        ("direct_conv_bwd", tuple(f"monarch_conv_bwd_kernel{k}" for lm in range(3, 9)
                                  for k in (f"<{lm},", f"ILi{lm}E"))),
        ("direct_conv", ("direct_conv_tc_kernel",)),
        ("monarch_conv_bwd", ("monarch_conv_bwd_kernel",)),
        ("dk_finish", ("dk_finish_kernel",)),
        ("monarch_conv", ("monarch_conv_kernel",)),
        ("spectrum", ("spectrum_kernel",)),
        ("depthwise_bwd", ("depthwise_bwd_",)),
        ("depthwise", ("depthwise_",)),
        ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")),
        ("copy or cast", ("copy_kernel",)),
        ("collective (nccl)", ("nccl",)),
        ("optimizer (foreach)", ("multi_tensor_apply",)),
    ):
        if any(k in name for k in keys):
            return kind
    return "other"


def _trace(torch, what, fn):
    """Device time by kernel and by kind over one call of fn (after a warm-up
    call), with torch.profiler, and the wall time of one more call with the
    profiler off. The idle share of an unprofiled call is estimated from the
    two: the profiled call's device busy time over the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        # "nccl:<collective>" is the profiler's range around a collective's
        # kernel on the device, not a kernel: counting it doubles NCCL time
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if on_device and not ev.name.startswith("nccl:"):
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total / 1e3 if hasattr(ev, "device_time_total") \
                else ev.cuda_time_total / 1e3
            k[1] += 1
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy = sum(t for t, _ in kernels.values())
    by_kind = {}
    for name, (t, n) in kernels.items():
        kind = by_kind.setdefault(_kind(name), [0.0, 0])
        kind[0] += t
        kind[1] += n
    log(f"profile: {what}, wall {wall_ms:.2f} ms (profiler on), device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%}); the next call unprofiled {unprofiled_ms:.2f} ms of wall "
        f"(idle share estimated {max(0.0, 1 - busy / unprofiled_ms):.1%})")
    for kind, (t, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        log(f"  {kind}: {t:.3f} ms in {n} launches ({t / busy:.1%} of device time)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, n) in top:
        log(f"    {t:8.3f} ms {n:4d}x {name[:110]}")
    return {"wall_ms": wall_ms, "unprofiled_wall_ms": unprofiled_ms, "device_busy_ms": busy,
            "by_kind_ms": {k: v[0] for k, v in by_kind.items()},
            "by_kind_launches": {k: v[1] for k, v in by_kind.items()},
            "top": [(name, t, n) for name, (t, n) in top]}


def _copy_sources(torch, what, step, forward, top=3):
    """The largest copies of one call of step (after a warm-up call) and the
    lines that make them. torch.profiler (record_shapes) gives each
    aten::copy_ shape's device time; the Python stack of every copy op
    (clone, _to_copy, copy_) of that shape in one call of forward, which
    runs on this thread (a backward's ops run on the autograd engine's
    threads, where the profiler recorded no stack on the card), comes from a
    TorchDispatchMode."""
    import traceback

    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    shapes = {}
    for e in prof.events():
        if e.name == "aten::copy_" and e.input_shapes and e.input_shapes[0]:
            g = shapes.setdefault(tuple(e.input_shapes[0]), [0.0, 0])
            g[0] += e.device_time_total / 1e3
            g[1] += 1
    biggest = sorted(shapes.items(), key=lambda kv: -kv[1][0])[:top]
    copies = {torch.ops.aten.clone.default, torch.ops.aten._to_copy.default,
              torch.ops.aten.copy_.default}
    here = str(HERE)

    class Lines(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.found = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in copies and isinstance(out, torch.Tensor) and tuple(out.shape) in shapes:
                frames = tuple(f"{f.filename[len(here) + 1:]}:{f.lineno} {f.name}"
                               for f in traceback.extract_stack()[:-1]
                               if f.filename.startswith(here))
                key = (tuple(out.shape), str(func), frames[-6:])
                self.found[key] = self.found.get(key, 0) + 1
            return out

    lines = Lines()
    with lines:
        forward()
    torch.cuda.synchronize()
    log(f"copy sources: {what}")
    out = []
    for shape, (ms, n) in biggest:
        log(f"  aten::copy_ {ms:.2f} ms of device time in {n} calls, output {list(shape)}")
        made = [(k[1], k[2], c) for k, c in lines.found.items() if k[0] == shape]
        for op, frames, c in made:
            log(f"    {op} x{c} in one forward, from:")
            for fr in frames:
                log(f"      {fr}")
        out.append({"ms": ms, "calls": n, "shape": list(shape),
                    "forward_ops": [(op, list(fr), c) for op, fr, c in made]})
    return out


def phase_profile(torch, seed):
    """Device time by kernel over one Hyena-125M serving forward and one
    train step (dropout on, the examples/lm optimizer), one train step of the
    same model in parallel_train's recipe on a (dp, tp) = (1, 1) mesh, one on
    a 1-rank sequence mesh, then one HyenaDNA forward and
    train step, one M2-BERT forward and train step, one GPT-2 124M and one
    windowed GPT forward and train step, one H3-125M forward and train step,
    one ListOps train step, one ViT-B/16 and one BERT-base forward and train
    step, and one train step of Hyena-125M with MoE MLPs."""
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    model = _hyena_125m(torch, seed, "cuda")
    ids = torch.randint(0, 256, (B, L_MAX + 1), generator=torch.Generator().manual_seed(seed))
    ids = ids.cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    res = {}
    with torch.inference_mode():
        res["forward"] = _trace(torch, "one serving forward", lambda: model.eval()(x))
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["train_step"] = _trace(torch, "one train step", lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    model, step = _parallel_lm(torch, seed, "cuda", _parallel_mesh(torch, ("dp", "tp")))
    res["parallel_train_step"] = _trace(
        torch, "one train step on a (dp, tp) = (1, 1) mesh (parallel_train's recipe)",
        lambda: step(x, y))
    del model, step
    torch.cuda.empty_cache()
    model = _hyena_125m(torch, seed, "cuda", {"seq_mesh": _seq_mesh(torch), "seq_axis": "sp"})
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["seq_train_step"] = _trace(torch, "one train step on a 1-rank sequence mesh",
                                   lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    from flashfftconv_tpu_torch.models import dna

    dna_model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(seed)).eval()
    bases = torch.from_numpy(dna.synthetic_genome(seed)[:DNA_L_MAX].astype("int64"))[None].cuda()
    with torch.inference_mode():
        res["dna_forward"] = _trace(torch, f"one HyenaDNA {DNA_MODEL} forward at {DNA_L_MAX} "
                                    "bases", lambda: dna_model(bases))
    del dna_model
    torch.cuda.empty_cache()
    dna_model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(seed),
                                **dna.train_config(DNA_MODEL))
    step = _dna_train_step(torch, dna_model)
    targets = torch.roll(bases, -1, dims=1)
    res["dna_train_step"] = _trace(torch, f"one HyenaDNA {DNA_MODEL} train step at {DNA_L_MAX} "
                                   "bases", lambda: step(bases, targets))
    res["dna_train_copies"] = _copy_sources(
        torch, f"one HyenaDNA {DNA_MODEL} train step", lambda: step(bases, targets),
        lambda: dna_model(bases))
    del dna_model, step
    torch.cuda.empty_cache()
    import numpy as np
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    model = _m2_bert(torch, seed, "cuda")
    x, y = (torch.from_numpy(a).cuda() for a in next(mlm_batches(
        _corpus(np), BERT_B, BERT_L, np.random.default_rng(seed))))
    with torch.inference_mode():
        res["bert_forward"] = _trace(torch, f"one M2-BERT {BERT_MODEL} forward at B={BERT_B} "
                                     f"L={BERT_L}", lambda: model.eval()(x))
    step = _bert_train_step(torch, model.train())
    res["bert_train_step"] = _trace(torch, f"one M2-BERT {BERT_MODEL} train step at B={BERT_B} "
                                    f"L={BERT_L}", lambda: step(x, y))
    del model, step
    torch.cuda.empty_cache()
    model = _gpt2(torch, seed, "cuda")
    x, y = _train_batches(torch, np, seed, "cuda", 1, GPT_TRAIN_B, GPT_L_MAX)[0]
    with torch.inference_mode():
        res["gpt_forward"] = _trace(torch, f"one GPT-2 124M forward at B={GPT_SERVE_B} "
                                    f"L={GPT_L_MAX}", lambda: model.eval()(x[:GPT_SERVE_B]))
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["gpt_train_step"] = _trace(torch, f"one GPT-2 124M train step at B={GPT_TRAIN_B} "
                                   f"L={GPT_L_MAX}", lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    model = _window_gpt(torch, seed, "cuda")
    x, y = _train_batches(torch, np, seed, "cuda", 1, WIN_TRAIN_B, WIN_L_MAX)[0]
    with torch.inference_mode():
        res["window_forward"] = _trace(torch, f"one windowed GPT forward at B={WIN_SERVE_B} "
                                       f"L={WIN_L_MAX}", lambda: model.eval()(x[:WIN_SERVE_B]))
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["window_train_step"] = _trace(torch, f"one windowed GPT train step at B={WIN_TRAIN_B} "
                                      f"L={WIN_L_MAX}", lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    model = _hyena_125m(torch, seed, "cuda", mixer="h3")
    x, y = _train_batches(torch, np, seed, "cuda", 1)[0]
    with torch.inference_mode():
        res["h3_forward"] = _trace(torch, f"one H3-125M forward at B={B} L={L_MAX}",
                                   lambda: model.eval()(x))
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["h3_train_step"] = _trace(torch, f"one H3-125M train step at B={B} L={L_MAX}",
                                  lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    from flashfftconv_tpu_torch.utils.optim import make_optimizer

    model = _listops_model(torch, seed, "cuda").train()
    opt, sched = make_optimizer(model.model, lr=4e-3, weight_decay=0.05, special_lr=1e-3,
                                warmup_steps=2)
    step = make_train_step(model, opt, sched, clip=math.inf)
    x, y = (t.cuda() for t in _listops_batch(torch, np, seed, LISTOPS_B, LISTOPS_L))
    res["listops_train_step"] = _trace(torch, f"one ListOps train step at B={LISTOPS_B} "
                                       f"L={LISTOPS_L}", lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    model = _vit_b16(torch, seed, "cuda")
    images, labels = _images(torch, seed, VIT_TRAIN_B, "cuda")
    with torch.inference_mode():
        res["vit_forward"] = _trace(torch, f"one ViT-B/16 forward at B={VIT_SERVE_B}",
                                    lambda: model.eval()(images[:VIT_SERVE_B]))
    opt = torch.optim.AdamW(model.parameters(), lr=5e-4 * VIT_TRAIN_B / 512, weight_decay=0.05)
    step = make_train_step(model.train(), opt, None, clip=1.0)
    res["vit_train_step"] = _trace(torch, f"one ViT-B/16 train step at B={VIT_TRAIN_B}",
                                   lambda: step(images, labels))
    del model, opt, step, images
    torch.cuda.empty_cache()
    model = _attn_bert(torch, seed, "cuda")
    batch = [t.cuda() for t in _padded_mlm_batch(torch, np, np.random.default_rng(seed), BERT_B,
                                                  BERT_L, _corpus(np))]
    with torch.inference_mode():
        res["attn_bert_forward"] = _trace(
            torch, f"one BERT-base forward at B={BERT_B} L={BERT_L}",
            lambda: model.eval()(batch[0], attention_mask=batch[1]))
    step = _attn_bert_step(torch, model.train())
    res["attn_bert_train_step"] = _trace(torch, f"one BERT-base train step at B={BERT_B} "
                                         f"L={BERT_L}", lambda: step(*batch))
    del model, step
    torch.cuda.empty_cache()
    model = _hyena_125m(torch, seed, "cuda", moe_kwargs=MOE_KWARGS)
    x, y = _train_batches(torch, np, seed, "cuda", 1)[0]
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["moe_train_step"] = _trace(torch, f"one Hyena-125M MoE train step at B={B} L={L_MAX}",
                                   lambda: step(x, y))
    return res


def _time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters=20) -> float:
    """Device time of one call of fn without the host's launch cost: iters
    calls captured in a CUDA graph, replayed 5 times after one replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tc_bound(flops: float) -> float:
    """ms of a function's products on the tensor cores: its operations times
    the split-TF32 passes of f32 operands at the dense TF32 rate."""
    return flops * TF32_PASSES / TF32_FLOPS * 1e3


def _fft_flops(m: int, n_stages: int) -> float:
    """f32 operations of one M-point complex FFT as the kernels do it: radix-2
    line DFTs (5 M log2 M) and the twiddles between stages (6 M each)."""
    return 5 * m * math.log2(m) + 6 * m * (n_stages - 1)


def phase_timing(torch, g):
    from flashfftconv_tpu_torch.ops import _build, monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(N_FFT, torch.bfloat16, device=dev)
    k, u, x, w, bias = _kernel_inputs(torch, g, dev)
    m, ns = plan.inner, plan.n_stages
    k_f = monarch_cuda.spectrum(plan, k)
    res = {}
    with torch.inference_mode():
        # spectrum: read f32 taps, write f32 half spectrum; one FFT and a split
        # a row. At the Hyena and H3 shape, then at M2-BERT's (H=768, k_len =
        # N = 256) and ListOps' (H=128, k_len = N = 4096). Beside the times of
        # back-to-back calls, which the host's launch cost bounds at the small
        # shapes, each call's device time from a CUDA graph (device_ms, the
        # kernel; library_device_ms, rfft).
        for name, kk, n in (("spectrum", k, N_FFT),
                            (f"spectrum@{BERT_N_FFT}",
                             (torch.randn(BERT_D_MODEL, BERT_N_FFT, generator=g) * 0.02).to(dev),
                             BERT_N_FFT),
                            (f"spectrum@{2 * LISTOPS_L}",
                             (torch.randn(LISTOPS_D, 2 * LISTOPS_L, generator=g) * 0.02).to(dev),
                             2 * LISTOPS_L)):
            p, h, mm = make_plan(n, torch.bfloat16, device=dev), kk.shape[0], n // 2
            res[name] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.spectrum(p, kk)),
                plain_ms=_time_ms(torch, lambda: monarch.kernel_spectrum(p, kk), iters=5),
                library_ms=_time_ms(torch, lambda: torch.fft.rfft(kk, n=n)),
                bound=_bound(kk.numel() * 4 + h * (mm + 1) * 8,
                             h * (_fft_flops(mm, p.n_stages) + 20 * (mm // 2))),
                device_ms=_graph_ms(torch, lambda: monarch_cuda.spectrum(p, kk)),
                library_device_ms=_graph_ms(torch, lambda: torch.fft.rfft(kk, n=n)),
            )
        # monarch_conv: read u and k_f, write y; two FFTs and the pointwise pass a
        # row. At the Hyena shape (bf16 I/O), at H3's second conv (the same
        # shape at f32 I/O) and at ListOps' (B=64, H=128, L=2048, N=4096, k_len =
        # N, f32 I/O); beside the times of back-to-back calls, each call's
        # device time from a CUDA graph (device_ms; library_device_ms, rfft ·
        # k_f -> irfft).
        n_lo = 2 * LISTOPS_L
        p_lo = make_plan(n_lo, torch.bfloat16, device=dev)
        u_lo = torch.randn(LISTOPS_B, LISTOPS_D, LISTOPS_L, generator=g).to(dev)
        kf_lo = monarch_cuda.spectrum(p_lo, (torch.randn(LISTOPS_D, n_lo, generator=g) * 0.02)
                                      .to(dev))
        for name, p, uu, kf in (("monarch_conv", plan, u, k_f),
                                ("monarch_conv@f32", plan, u.float(), k_f),
                                (f"monarch_conv@{n_lo}", p_lo, u_lo, kf_lo)):
            bb, hh, length = uu.shape
            n, mm = p.seqlen, p.inner

            def fft_conv(uu=uu, kf=kf, n=n, length=length):
                return torch.fft.irfft(torch.fft.rfft(uu.float(), n=n) * kf, n=n)[
                    ..., :length].to(uu.dtype)

            res[name] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.monarch_conv(p, uu, kf)),
                plain_ms=_time_ms(torch, lambda: monarch.conv_with_spectrum(p, uu, kf), iters=5),
                library_ms=_time_ms(torch, fft_conv),
                bound=_bound(uu.numel() * uu.element_size() * 2 + kf.numel() * 8,
                             bb * hh * (2 * _fft_flops(mm, p.n_stages) + 40 * (mm // 2)
                                        + 4 * length)),
                device_ms=_graph_ms(torch, lambda: monarch_cuda.monarch_conv(p, uu, kf)),
                library_device_ms=_graph_ms(torch, fft_conv),
            )
        # monarch_conv_bwd (ungated, as on the main paths): the function reads
        # u, dout and k_f and writes du and one (H, M+1) dk spectrum, summed
        # over B as the TPU kernel does on chip; three FFTs a row, about 60
        # operations a frequency pair, 4 a sample and the batch sum besides.
        # The design's own traffic, in neither bound, is overhead_ms: the
        # (B, H, M+1) park written once (L2 serves its read-back) and the
        # partials beyond one a channel. At the Hyena shape (bf16 I/O), H3's
        # f32-I/O conv and ListOps' (B=64, H=128, L=2048, N=4096, f32). Beside
        # it: the same kernel with group 1 (one partial a row, through the C
        # entry: c1_ms), each call's device time from a CUDA graph, and the
        # whole dk path, monarch_conv_bwd + dk_finish (whole_ms; c1_whole_ms
        # with group 1 and B partials), against rfft x2, irfft, the batch sum
        # and irfft (library_whole_ms).
        lib = _build.load("monarch_conv_bwd")

        def bwd_group1(p, uu, kf, dd):
            bb, hh, length = uu.shape
            du = torch.empty_like(uu)
            park = torch.empty(bb, hh, p.inner + 1, dtype=torch.complex64, device=dev)
            parts = torch.empty_like(park)
            rc = lib.ffc_monarch_conv_bwd(
                uu.data_ptr(), None, None, dd.data_ptr(), kf.data_ptr(), du.data_ptr(), None,
                None, park.data_ptr(), parts.data_ptr(), p.split_tw.data_ptr(), bb, hh, length,
                p.seqlen, 1, 0 if uu.dtype == torch.float32 else 1, monarch_cuda._stream(dev))
            _build.check(lib, rc, "monarch_conv_bwd kernel, group 1")
            return du, None, None, parts

        dout = (torch.randn(u.shape, generator=g) * 0.02).to(dev, u.dtype)
        d_lo = (torch.randn(u_lo.shape, generator=g) * 0.02).to(dev)
        bwd_shapes = (("monarch_conv_bwd", plan, u, k_f, dout, L_MAX),
                      ("monarch_conv_bwd@f32", plan, u.float(), k_f, dout.float(), L_MAX),
                      (f"monarch_conv_bwd@{n_lo}", p_lo, u_lo, kf_lo, d_lo, n_lo))
        bwd_parts = {name: monarch_cuda.monarch_conv_bwd(p, uu, kf, None, None, dd)[3]
                     for name, p, uu, kf, dd, _ in bwd_shapes}
        # dk_finish, timed before the backward rows (timed after their CUDA
        # graphs, its back-to-back calls were host-bound): the function
        # reads one (H, M+1) dk spectrum and writes dk; the unsplit (20 a
        # pair) and one inverse FFT a channel. At the
        # Hyena shape and ListOps' (k_len = N), on the partials that
        # monarch_conv_bwd gives there ((1, 768, 8193) and (8, 128, 2049)),
        # and at M2-BERT's (B=128, H=768, N=256, k_len = N, 128 partials);
        # reading more than one spectrum is the design's own traffic
        # (overhead_ms); beside the back-to-back times, a CUDA graph's device
        # time a call (device_ms; library_device_ms, sum and irfft).
        for name, pp, pa, k_len in (
                ("dk_finish", plan, bwd_parts["monarch_conv_bwd"], L_MAX),
                (f"dk_finish@{BERT_N_FFT}", make_plan(BERT_N_FFT, torch.bfloat16, device=dev),
                 torch.randn(BERT_B, BERT_D_MODEL, BERT_N_FFT // 2 + 1, dtype=torch.complex64,
                             generator=g).to(dev), BERT_N_FFT),
                (f"dk_finish@{n_lo}", p_lo, bwd_parts[f"monarch_conv_bwd@{n_lo}"], n_lo)):
            bb, hh, m1 = pa.shape
            n = pp.seqlen

            def lib_dk(pa=pa, n=n, k_len=k_len):
                return torch.fft.irfft(pa.sum(0), n=n)[..., :k_len]

            res[name] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.dk_finish(pp, pa, k_len)),
                plain_ms=_time_ms(torch, lambda: monarch.dk_finish_plain(pp, pa, k_len),
                                  iters=5),
                library_ms=_time_ms(torch, lib_dk),
                bound=_bound(hh * m1 * 8 + hh * k_len * 4,
                             hh * (_fft_flops(m1 - 1, pp.n_stages) + 20 * ((m1 - 1) // 2))),
                overhead_ms=(bb - 1) * hh * m1 * 8 / HBM_BYTES_PER_S * 1e3,
                device_ms=_graph_ms(torch, lambda: monarch_cuda.dk_finish(pp, pa, k_len)),
                library_device_ms=_graph_ms(torch, lib_dk),
            )
        for name, p, uu, kf, dd, k_len in bwd_shapes:
            bb, hh, length = uu.shape
            n, mm = p.seqlen, p.inner
            parts = bwd_parts[name]
            spec, io = hh * (mm + 1) * 8, uu.numel() * uu.element_size()
            flops = bb * hh * (3 * _fft_flops(mm, p.n_stages) + 60 * (mm // 2) + 4 * length
                               + 2 * (mm + 1))
            dk_flops = hh * (_fft_flops(mm, p.n_stages) + 20 * (mm // 2))

            def kernel(p=p, uu=uu, kf=kf, dd=dd):
                return monarch_cuda.monarch_conv_bwd(p, uu, kf, None, None, dd)

            def fft_bwd(uu=uu, kf=kf, dd=dd, n=n, length=length):
                g_f, u_f = torch.fft.rfft(dd.float(), n=n), torch.fft.rfft(uu.float(), n=n)
                du = torch.fft.irfft(g_f * kf.conj(), n=n)[..., :length].to(uu.dtype)
                return du, g_f * u_f.conj()

            def whole(bwd=kernel, p=p, k_len=k_len):
                du, _, _, pa = bwd()
                return du, monarch_cuda.dk_finish(p, pa, k_len)

            def fft_whole(uu=uu, kf=kf, dd=dd, n=n, length=length, k_len=k_len):
                g_f = torch.fft.rfft(dd.float(), n=n)
                du = torch.fft.irfft(g_f * kf.conj(), n=n)[..., :length].to(uu.dtype)
                g_f = g_f * torch.fft.rfft(uu.float(), n=n).conj()
                return du, torch.fft.irfft(g_f.sum(0), n=n)[..., :k_len]

            group1 = lambda p=p, uu=uu, kf=kf, dd=dd: bwd_group1(p, uu, kf, dd)
            res[name] = dict(
                ms=_time_ms(torch, kernel),
                plain_ms=_time_ms(torch, lambda: monarch.conv_bwd_plain(p, uu, kf, None, None,
                                                                        dd), iters=5),
                library_ms=_time_ms(torch, fft_bwd),
                bound=_bound(3 * io + 2 * spec, flops),
                overhead_ms=(parts.numel() * 8 - spec + bb * spec) / HBM_BYTES_PER_S * 1e3,
                device_ms=_graph_ms(torch, kernel),
                library_device_ms=_graph_ms(torch, fft_bwd),
                c1_ms=_time_ms(torch, group1),
                c1_device_ms=_graph_ms(torch, group1),
                whole_ms=_time_ms(torch, whole),
                c1_whole_ms=_time_ms(torch, lambda: whole(group1)),
                library_whole_ms=_time_ms(torch, fft_whole),
                whole_bound=_bound(3 * io + spec + hh * k_len * 4, flops + dk_flops),
            )
        del u_lo, kf_lo, d_lo, bwd_parts
    del k, u, x, k_f, dout
    torch.cuda.empty_cache()
    for rows in (_time_depthwise(torch, g), _time_direct(torch, g), _time_long(torch, g),
                 _time_band(torch, g), _time_attention(torch, g), _time_splash(torch, g),
                 _time_smem(torch, g)):
        if set(rows) & set(res):
            raise AssertionError(f"timing rows named twice: {sorted(set(rows) & set(res))}")
        res.update(rows)
    for name, r in res.items():
        extra = (f", the design's own traffic beyond the bound {r['overhead_ms']:.4f} ms"
                 if "overhead_ms" in r else "")
        if "library_fwd_bwd_ms" in r:
            extra += f", the library's forward + backward {r['library_fwd_bwd_ms']:.4f} ms"
        if "device_ms" in r:
            extra += (f", device time a call {r['device_ms']:.4f} ms (library "
                      f"{r['library_device_ms']:.4f} ms)")
        if "kernel_ms" in r:
            extra += (f"; the band kernel alone {r['kernel_ms']:.4f} ms, device "
                      f"{r['kernel_device_ms']:.4f} ms, bound {r['kernel_bound'][0]:.4f} ms "
                      f"({r['kernel_bound'][1]})")
        if "c1_ms" in r:
            extra += (f"; group 1 (a partial a row) {r['c1_ms']:.4f} ms, device "
                      f"{r['c1_device_ms']:.4f} ms; whole (with dk_finish) {r['whole_ms']:.4f} "
                      f"ms, group 1 {r['c1_whole_ms']:.4f} ms, library "
                      f"{r['library_whole_ms']:.4f} ms, bound {r['whole_bound'][0]:.4f} ms "
                      f"({r['whole_bound'][1]})")
        if "causal_flash_ms" in r:
            extra += f", the causal flash kernel at this shape {r['causal_flash_ms']:.4f} ms"
        if "tc_bound" in r:
            extra += f", tc_bound {r['tc_bound']:.4f} ms ({TF32_PASSES} TF32 passes)"
        if "pair_ms" in r:
            extra += (f", dK/dV + dQ {r['pair_ms']:.4f} ms against the library's backward "
                      f"{r['library_ms']:.4f} ms")
        if "tile_bytes" in r:
            extra += (f", {r['tile_bytes'] // 1024} KB tiles, "
                      f"{2 * r['bytes'] / r['ms'] / 1e6:.1f} GB/s")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"timing {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}){extra}")
    return res

# The short depthwise conv's shapes on the main paths (BHL, K=3, bf16): name
# suffix, (B, D, L) and padding. Hyena-125M's (models/hyena.py:65, causal),
# M2-BERT's (models/m2_bert.py:89, "same") and HyenaDNA large-1m's.
DW_SHAPES = (("", (B, 3 * D_MODEL, L_MAX), (2, 0)),
             ("@bert", (BERT_B, 3 * BERT_D_MODEL, BERT_L), (1, 1)),
             ("@dna", (1, 3 * DNA_D_MODEL, DNA_L_MAX), (2, 0)))


def _time_depthwise(torch, g):
    """depthwise and depthwise_bwd at each DW_SHAPES shape: back-to-back
    calls (ms), a CUDA graph's device time a call (device_ms), the plain
    versions, and the library: a grouped F.conv1d (forward) and
    aten.convolution_backward (du, dk and dbias) with their device times.
    Bounds: the forward reads x and writes out, 2K + 1 operations an output;
    the backward reads x and dout and writes du, dk and dbias, 4K + 1
    operations a position. The (D, tiles, K + 1) f32 partials that the
    backward writes and reads back are its design's own traffic
    (overhead_ms), in neither bound."""
    import torch.nn.functional as F

    from flashfftconv_tpu_torch.ops import _build
    from flashfftconv_tpu_torch.ops import depthwise as dw

    dev = torch.device("cuda")
    res = {}
    for suffix, (b, d, length), pad in DW_SHAPES:
        k = 3
        x = torch.randn(b, d, length, generator=g).to(dev, torch.bfloat16)
        w = (torch.rand(d, k, generator=g) * 2 / math.sqrt(d)).to(dev)
        bias = (torch.randn(d, generator=g) * 0.1).to(dev)
        dy = torch.randn(b, d, length, generator=g).to(dev, torch.bfloat16)
        wb, bb = w[:, None, :].to(x.dtype), bias.to(x.dtype)
        # the grouped conv pads both ends by the larger pad; a causal conv
        # keeps its first L outputs, and its backward takes dout zero after
        p = max(pad)
        dy_full = F.pad(dy, (0, 2 * p - sum(pad)))
        tiles = _build.load("depthwise_bwd").ffc_depthwise_bwd_tiles(b, length)
        parts = d * tiles * (k + 1) * 4
        big = x.numel() > 1 << 28  # the plain versions' f32 temporaries
        reps = dict(iters=2, warmup=1) if big else dict(iters=5)

        def fwd(x=x, w=w, bias=bias, pad=pad):
            return dw.depthwise(x, w, bias, pad, True)

        def lib_fwd(x=x, wb=wb, bb=bb, p=p, length=length):
            return F.conv1d(x, wb, bb, padding=p, groups=x.shape[1])[..., :length]

        def bwd(x=x, w=w, dy=dy, pad=pad):
            return dw.depthwise_bwd(x, w, dy, pad, True)

        def lib_bwd(x=x, wb=wb, dy_full=dy_full, p=p):
            return torch.ops.aten.convolution_backward(
                dy_full, x, wb, [x.shape[1]], [1], [p], [1], False, [0], x.shape[1],
                [True, True, True])

        with torch.inference_mode():
            res["depthwise" + suffix] = dict(
                ms=_time_ms(torch, fwd),
                device_ms=_graph_ms(torch, fwd),
                plain_ms=_time_ms(torch, lambda: dw.depthwise_plain(x, w, bias, pad, True),
                                  **reps),
                library_ms=_time_ms(torch, lib_fwd),
                library_device_ms=_graph_ms(torch, lib_fwd),
                bound=_bound(x.numel() * 2 * 2, x.numel() * (2 * k + 1)),
            )
            res["depthwise_bwd" + suffix] = dict(
                ms=_time_ms(torch, bwd),
                device_ms=_graph_ms(torch, bwd),
                plain_ms=_time_ms(torch, lambda: dw.depthwise_bwd_plain(x, w, dy, pad, True),
                                  **reps),
                library_ms=_time_ms(torch, lib_bwd),
                library_device_ms=_graph_ms(torch, lib_bwd),
                bound=_bound(x.numel() * 2 * 3 + d * (k + 1) * 4, x.numel() * (4 * k + 1)),
                overhead_ms=2 * parts / HBM_BYTES_PER_S * 1e3,
            )
        del x, dy, dy_full
        torch.cuda.empty_cache()
    return res


def _time_smem(torch, g):
    """The probe kernels with utils.benchmarking (CUDA events, 10 launches
    after 3 warm-ups): smem_probe_touch at the largest working size (one
    block; it moves 8 KB, so its time is a launch's) and smem_copy over
    256 MiB of f32 at 16 KB, 64 KB and the largest tile (the row named
    smem_copy), beside torch.mul, the library call of the same function. The
    bound counts each float read once and written once (the copy: 512 MiB
    over 3.35 TB/s) against one multiply an element."""
    from flashfftconv_tpu_torch.utils import benchmarking as bench
    from flashfftconv_tpu_torch.utils import smem_probe as sp

    def timed(fn, *args):
        return bench.benchmark_forward(fn, *args, repeats=10, warmup=3, device="cuda")

    best = sp.grid_floor(sp.device_attrs("cuda")["max_shared_per_block_optin"])
    x = torch.randn(sp.PROBE_SHAPE, generator=g).cuda()
    rows = {"smem_probe_touch": dict(
        ms=timed(sp.smem_probe_touch, x, best), plain_ms=timed(sp.touch_plain, x),
        library_ms=None, bound=_bound(2 * x.numel() * 4, 3 * x.numel()))}
    src = torch.randn(sp.COPY_BYTES // 4, generator=g).cuda()
    nbytes = 2 * src.numel() * 4
    library_ms = timed(torch.mul, src, 1.0001)
    plain_ms = timed(sp.copy_plain, src)
    for tile, name in ((16 * 1024, "smem_copy@16KB"), (64 * 1024, "smem_copy@64KB"),
                       (best, "smem_copy")):
        rows[name] = dict(ms=timed(sp.smem_copy, src, tile), plain_ms=plain_ms,
                          library_ms=library_ms, bound=_bound(nbytes, src.numel()),
                          tile_bytes=tile, bytes=src.numel() * 4)
    return rows


def _time_direct(torch, g):
    """The direct path's kernels at the M2-BERT path's shape (B=128, H=768,
    L=128, N=256, bf16, ungated) and at N=512, L=256. The bound counts what
    the function needs: its inputs read once and its outputs written once,
    against the f32 operations of the same function with FFTs, counted as in
    phase_timing. The forward's dense transforms are its design's own work:
    its two real DFT products (2 L N operations a row each) on the tensor
    cores as tc_bound. The backward is the row-FFT backward's instance for N
    (three FFTs a row); its park ((B, H, M+1) written once) and the dk
    partials beyond one spectrum are its design's own traffic (overhead_ms).
    Beside each: monarch_conv and monarch_conv_bwd (the same backward
    through the Monarch wrapper) at the same shape, dk_finish on the
    backward's 16 partials (dk_finish@Nx16), each call's device time from a
    CUDA graph and the library's."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    res = {}
    with torch.inference_mode():
        for n in (BERT_N_FFT, 2 * BERT_N_FFT):
            plan = make_plan(n, torch.bfloat16, device=dev)
            b, h, length, m, ns = BERT_B, BERT_D_MODEL, n // 2, n // 2, plan.n_stages
            t = torch.arange(n, dtype=torch.float32)
            k = (torch.randn(h, n, generator=g) * 0.02 * torch.exp(-t / 50)).to(dev)
            u, dout = ((torch.randn(b, h, length, generator=g) * 0.02).to(dev, torch.bfloat16)
                       for _ in "ab")
            k_f = monarch_cuda.spectrum(plan, k)
            rows, io, spec = b * h, u.numel() * 2, k_f.numel() * 8
            fwd_ops = rows * (2 * _fft_flops(m, ns) + 40 * (m // 2) + 4 * length)
            bwd_ops = rows * (3 * _fft_flops(m, ns) + 60 * (m // 2) + 4 * length + 2 * (m + 1))
            # the main path's rows keep the kernels' names; the others carry N
            sfx = "" if n == BERT_N_FFT else f"@{n}"

            def fft_conv():
                return torch.fft.irfft(torch.fft.rfft(u.float(), n=n) * k_f, n=n)[
                    ..., :length].to(u.dtype)

            def fft_bwd():
                g_f, u_f = torch.fft.rfft(dout.float(), n=n), torch.fft.rfft(u.float(), n=n)
                du = torch.fft.irfft(g_f * k_f.conj(), n=n)[..., :length].to(u.dtype)
                return du, (g_f * u_f.conj()).sum(0)

            # direct_conv: u and k_f in, y out; the kernel runs two dense
            # real DFT products a row on the tensor cores (L N multiply-adds
            # each; tc_bound) and the pointwise product
            conv = lambda: monarch_cuda.direct_conv(plan, u, k_f)
            res["direct_conv" + sfx] = dict(
                ms=_time_ms(torch, conv),
                plain_ms=_time_ms(torch, lambda: monarch.direct_conv_plain(plan, u, k_f), iters=5),
                library_ms=_time_ms(torch, fft_conv),
                bound=_bound(2 * io + spec, fwd_ops),
                tc_bound=_tc_bound(rows * 4 * length * n),
                device_ms=_graph_ms(torch, conv),
                library_device_ms=_graph_ms(torch, fft_conv),
            )
            mconv = lambda: monarch_cuda.monarch_conv(plan, u, k_f)
            res[f"monarch_conv@{n}"] = dict(
                ms=_time_ms(torch, mconv),
                plain_ms=_time_ms(torch, lambda: monarch.conv_with_spectrum(plan, u, k_f),
                                  iters=5),
                library_ms=_time_ms(torch, fft_conv),
                bound=_bound(2 * io + spec, fwd_ops),
                device_ms=_graph_ms(torch, mconv),
                library_device_ms=_graph_ms(torch, fft_conv),
            )
            # direct_conv_bwd: u, dout and k_f in, du and one dk spectrum out
            # (the function); the kernel leaves B / bwd_group(B) partials
            bwd_plain = lambda: monarch.conv_bwd_plain(plan, u, k_f, None, None, dout)
            parts = monarch_cuda.direct_conv_bwd(plan, u, k_f, None, None, dout)[3]
            overhead = (parts.numel() * 8 - spec + rows * (m + 1) * 8) / HBM_BYTES_PER_S * 1e3
            for name, fn in (("direct_conv_bwd" + sfx, monarch_cuda.direct_conv_bwd),
                             (f"monarch_conv_bwd@{n}", monarch_cuda.monarch_conv_bwd)):
                bwd = lambda fn=fn: fn(plan, u, k_f, None, None, dout)
                res[name] = dict(
                    ms=_time_ms(torch, bwd),
                    plain_ms=_time_ms(torch, bwd_plain, iters=5),
                    library_ms=_time_ms(torch, fft_bwd),
                    bound=_bound(3 * io + 2 * spec, bwd_ops),
                    overhead_ms=overhead,
                    device_ms=_graph_ms(torch, bwd),
                    library_device_ms=_graph_ms(torch, fft_bwd),
                )
            fin = lambda: monarch_cuda.dk_finish(plan, parts, n)
            lib_fin = lambda: torch.fft.irfft(parts.sum(0), n=n)
            res[f"dk_finish@{n}x{parts.shape[0]}"] = dict(
                ms=_time_ms(torch, fin),
                plain_ms=_time_ms(torch, lambda: monarch.dk_finish_plain(plan, parts, n),
                                  iters=5),
                library_ms=_time_ms(torch, lib_fin),
                bound=_bound(spec + h * n * 4, h * (_fft_flops(m, ns) + 20 * (m // 2))),
                overhead_ms=(parts.numel() * 8 - spec) / HBM_BYTES_PER_S * 1e3,
                device_ms=_graph_ms(torch, fin),
                library_device_ms=_graph_ms(torch, lib_fin),
            )
            if n == BERT_N_FFT:
                # The whole direct backward of one conv as FftConvFunction runs
                # it: spectrum of the taps, direct_conv_bwd, dk_finish; u, dout
                # and the taps in, du and f32 dk out; beside the five torch.fft
                # calls of the same function.
                def direct_bwd():
                    kf = monarch_cuda.spectrum(plan, k)
                    du, _, _, parts = monarch_cuda.direct_conv_bwd(plan, u, kf, None, None, dout)
                    return du, monarch_cuda.dk_finish(plan, parts, n)

                def plain_bwd():
                    kf = monarch.kernel_spectrum(plan, k)
                    du, _, _, parts = monarch.conv_bwd_plain(plan, u, kf, None, None, dout)
                    return du, monarch.dk_finish_plain(plan, parts, n)

                def fft_whole_bwd():
                    kf = torch.fft.rfft(k, n=n)
                    g_f = torch.fft.rfft(dout.float(), n=n)
                    du = torch.fft.irfft(g_f * kf.conj(), n=n)[..., :length].to(u.dtype)
                    g_f = g_f * torch.fft.rfft(u.float(), n=n).conj()
                    return du, torch.fft.irfft(g_f.sum(0), n=n)

                res["direct_bwd_chain"] = dict(
                    ms=_time_ms(torch, direct_bwd),
                    plain_ms=_time_ms(torch, plain_bwd, iters=5),
                    library_ms=_time_ms(torch, fft_whole_bwd),
                    bound=_bound(3 * io + 2 * k.numel() * 4,
                                 bwd_ops + 2 * h * (_fft_flops(m, ns) + 20 * (m // 2))),
                    overhead_ms=overhead + (parts.numel() * 8 - spec) / HBM_BYTES_PER_S * 1e3,
                    device_ms=_graph_ms(torch, direct_bwd),
                    library_device_ms=_graph_ms(torch, fft_whole_bwd),
                )
            del u, dout, k, k_f, parts
    torch.cuda.empty_cache()
    return res


def _time_band(torch, g):
    """band_conv at the seq_train path's shape (B=4, H=768, N2=16384,
    complex64). The function reads the bands and the spectrum once and
    writes the bands once, and needs two N2-point complex FFTs a row (radix-2
    line DFTs and the twiddles between the kernel plan's stages, as
    _fft_flops counts them) and the complex product (6 a point)."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(2 * SEQ_N2, torch.float32, device=dev)
    gd = torch.Generator(device=dev).manual_seed(g.initial_seed())
    b = torch.randn(B, D_MODEL, SEQ_N2, dtype=torch.complex64, device=dev, generator=gd)
    k_f = torch.randn(D_MODEL, SEQ_N2, dtype=torch.complex64, device=dev, generator=gd)
    nbytes = b.numel() * 8 * 2 + k_f.numel() * 8
    flops = B * D_MODEL * (2 * _fft_flops(SEQ_N2, plan.n_stages) + 6 * SEQ_N2)
    conv = lambda: monarch_cuda.band_conv(plan, b, k_f)
    lib = lambda: torch.fft.ifft(torch.fft.fft(b) * k_f)
    with torch.inference_mode():
        res = {"band_conv": dict(
            ms=_time_ms(torch, conv),
            plain_ms=_time_ms(torch, lambda: monarch.band_conv_plain(plan, b, k_f), iters=5),
            library_ms=_time_ms(torch, lib),
            bound=_bound(nbytes, flops),
            device_ms=_graph_ms(torch, conv),
            library_device_ms=_graph_ms(torch, lib),
        )}
    del b, k_f
    torch.cuda.empty_cache()
    return res


def _time_attention(torch, g):
    """The attention kernels at the gpt_train path's shape (B=16, H=12,
    L=1024, D=64, f32, causal), at vit_train's (rows flash_attn_*@vit:
    B=128, H=12, L=197, D=64, f32, non-causal) and attn_bert_train's (rows
    @bert: B=128, H=12, L=128, D=64, f32, non-causal, segment ids of a
    padding mask with rows of 64-128 tokens), then at head_dim 256, 640 and
    1024 (rows flash_attn_*@256, @640, @1024: B=4, H=8, L=2048, f32, causal;
    the wide bodies, above 512 in D slices of 256 columns).
    Bytes: each input read once, each output written once. Operations: each
    function's products over the score elements the mask keeps (the causal
    half; all of them non-causal; with segment ids the pairs within a
    segment), 2 a multiply-add: the forward q k^T and p v (4 B H L^2 D in
    all unmasked); dK/dV q k^T,
    do v^T, p^T do and ds^T q (8); dQ q k^T, do v^T and ds k (6); the two
    backward kernels recompute q k^T and do v^T each, which the fused
    backward (10) would not. tc_bound: a row's operations on the tensor
    cores, 3 split-TF32 passes at 494.7 TFLOP/s. library_ms is
    scaled_dot_product_attention's forward for the forward row and its
    backward (dq, dk and dv in one call) for both backward rows, beside
    which the dQ row carries pair_ms, dK/dV + dQ."""
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    res = _flash_rows(torch, g, GPT_TRAIN_B, GPT_HEADS, GPT_L_MAX, GPT_HEAD_DIM, "")
    res.update(_flash_rows(torch, g, VIT_TRAIN_B, VIT_HEADS, VIT_L, 64, "@vit", causal=False))
    res.update(_flash_rows(torch, g, BERT_B, ABERT_HEADS, BERT_L, 64, "@bert", causal=False,
                           seg=_padding_segments(torch, g, BERT_B, BERT_L, "cuda")))
    for d in (256, 640, 1024):
        # only where the checkout's kernels take d, so that this phase also
        # times a commit from before head_dim 640 was taken (an A/B)
        if ac.kernels_take(*[torch.empty(1, 1, 1, d, device="meta")] * 3):
            res.update(_flash_rows(torch, g, 4, 8, 2048, d, f"@{d}"))
    return res


def _flash_rows(torch, g, b, h, l, d, suffix, causal=True, seg=None):
    """The three flash rows of _time_attention at (B, H, L, D), f32, each
    name with suffix; ``seg`` (B, L) int32 segment ids, which SDPA gets as a
    boolean (B, 1, L, L) mask. One product's operations count the score
    elements the mask keeps: the causal half, or with segment ids each row's
    n^2 + (L - n)^2."""
    import torch.nn.functional as F

    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda")
    q, k, v, do = _attn_inputs(torch, g, dev, b, h, l, d, torch.float32)
    n, stats = q.numel() * 4, b * h * l * 4
    if seg is None:
        kept = b * l * l / 2 if causal else b * l * l
        mask, seg_bytes = None, 0
    else:
        n_valid = seg.sum(1).double()
        kept = float((n_valid**2 + (l - n_valid) ** 2).sum())
        mask, seg_bytes = (seg[:, None, :, None] == seg[:, None, None, :]), seg.numel() * 4
    prod_ops = 2 * h * d * kept  # one product over the kept scores, 2 a multiply-add
    sdpa = dict(attn_mask=mask, is_causal=causal)
    args = (causal, None, None, seg)
    o, lse = ac.flash_attn_fwd(q, k, v, *args)
    delta = plain.attention_delta(o, do)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa)
    sdpa_bwd = _time_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                           retain_graph=True), iters=10)
    plain_bwd = _time_ms(torch, lambda: plain.flash_attn_bwd_plain(q, k, v, o, lse, do, *args),
                         iters=3, warmup=1)
    with torch.inference_mode():
        fwd, dkv, dq = (f"flash_attn_fwd{suffix}", f"flash_attn_bwd_dkv{suffix}",
                        f"flash_attn_bwd_dq{suffix}")
        res = {
            fwd: dict(
                ms=_time_ms(torch, lambda: ac.flash_attn_fwd(q, k, v, *args), iters=10),
                plain_ms=_time_ms(torch, lambda: plain.flash_attn_fwd_plain(q, k, v, *args),
                                  iters=3, warmup=1),
                library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, **sdpa), iters=10),
                bound=_bound(3 * n + seg_bytes + n + stats, 2 * prod_ops),
                tc_bound=_tc_bound(2 * prod_ops),
            ),
            dkv: dict(
                ms=_time_ms(torch, lambda: ac.flash_attn_bwd_dkv(q, k, v, do, lse, delta, *args),
                            iters=10),
                plain_ms=plain_bwd, library_ms=sdpa_bwd,
                bound=_bound(4 * n + seg_bytes + 2 * stats + 2 * n, 4 * prod_ops),
                tc_bound=_tc_bound(4 * prod_ops),
            ),
            dq: dict(
                ms=_time_ms(torch, lambda: ac.flash_attn_bwd_dq(q, k, v, do, lse, delta, *args),
                            iters=10),
                plain_ms=plain_bwd, library_ms=sdpa_bwd,
                bound=_bound(4 * n + seg_bytes + 2 * stats + n, 3 * prod_ops),
                tc_bound=_tc_bound(3 * prod_ops),
            ),
        }
        res[dq]["pair_ms"] = res[dkv]["ms"] + res[dq]["ms"]
    del q, k, v, do, o, lse, delta, qs, ks, vs, out, mask
    torch.cuda.empty_cache()
    return res


def _time_splash(torch, g):
    """The splash kernels at the window_train path's shape (B=8, H=12,
    L=2048, D=64, f32, W=256), and the forward at benchmarks/
    tpu_attention.py's block-sparse case (B=2, H=4, L=1024, D=128, bf16,
    256-wide blocks, causal). Bytes: each input read once, each output
    written once. Operations: the products over the elements the mask keeps
    (491,648 a (b, h) here, not L W), 2 a multiply-add: the forward q k^T and
    p v (4 a kept element a channel), dK/dV q k^T, do v^T, p^T do and ds^T q
    (8), dQ q k^T, do v^T and ds k (6); tc_bound as in _time_attention.
    library_ms is scaled_dot_product_attention with the dense boolean mask
    as attn_mask (f32 for the window; it has no block skipping): its forward for the
    forward rows, its backward (dq, dk and dv in one call) for both backward
    rows; library_fwd_bwd_ms is its forward and backward together.
    causal_flash_ms is flash_attn_fwd, causal, at the same shape: the
    window's tiles are 0.28 of the causal ones, and the forward must take at
    most half its time."""
    import numpy as np
    import torch.nn.functional as F

    from flashfftconv_tpu_torch.ops import attention as plain
    from flashfftconv_tpu_torch.ops import attention_cuda as ac
    from flashfftconv_tpu_torch.ops.splash_mask import SplashMask

    dev = torch.device("cuda")
    b, h, l, d = WIN_TRAIN_B, GPT_HEADS, WIN_L_MAX, GPT_HEAD_DIM
    mask = SplashMask.local(l, WIN_W)
    keep = mask.dense(dev)
    q, k, v, do = _attn_inputs(torch, g, dev, b, h, l, d, torch.float32)
    n, stats = q.numel() * 4, b * h * l * 4
    kept_ops = b * h * int(keep.sum()) * d  # one product over the kept elements
    o, lse = ac.splash_attn_fwd(q, k, v, mask)
    delta = plain.attention_delta(o, do)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)

    out = sdpa()
    sdpa_bwd = _time_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                           retain_graph=True), iters=10)
    sdpa_fwd_bwd = _time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do),
                            iters=10)
    plain_bwd = _time_ms(torch, lambda: plain.splash_attn_bwd_plain(q, k, v, o, lse, do, keep),
                         iters=3, warmup=1)
    with torch.inference_mode():
        fwd_ms = _time_ms(torch, lambda: ac.splash_attn_fwd(q, k, v, mask), iters=10)
        causal_ms = _time_ms(torch, lambda: ac.flash_attn_fwd(q, k, v), iters=10)
        res = {
            "splash_attn_fwd": dict(
                ms=fwd_ms,
                plain_ms=_time_ms(torch, lambda: plain.splash_attn_fwd_plain(q, k, v, keep),
                                  iters=3, warmup=1),
                library_ms=_time_ms(torch, sdpa, iters=10),
                library_fwd_bwd_ms=sdpa_fwd_bwd, causal_flash_ms=causal_ms,
                bound=_bound(3 * n + n + stats, 4 * kept_ops),
                tc_bound=_tc_bound(4 * kept_ops),
            ),
            "splash_attn_bwd_dkv": dict(
                ms=_time_ms(torch, lambda: ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask),
                            iters=10),
                plain_ms=plain_bwd, library_ms=sdpa_bwd, library_fwd_bwd_ms=sdpa_fwd_bwd,
                bound=_bound(4 * n + 2 * stats + 2 * n, 8 * kept_ops),
                tc_bound=_tc_bound(8 * kept_ops),
            ),
            "splash_attn_bwd_dq": dict(
                ms=_time_ms(torch, lambda: ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask),
                            iters=10),
                plain_ms=plain_bwd, library_ms=sdpa_bwd, library_fwd_bwd_ms=sdpa_fwd_bwd,
                bound=_bound(4 * n + 2 * stats + n, 6 * kept_ops),
                tc_bound=_tc_bound(6 * kept_ops),
            ),
        }
        res["splash_attn_bwd_dq"]["pair_ms"] = (res["splash_attn_bwd_dkv"]["ms"]
                                                + res["splash_attn_bwd_dq"]["ms"])
    log(f"timing splash_attn_fwd: {fwd_ms:.4f} ms against the causal flash_attn_fwd's "
        f"{causal_ms:.4f} ms at the same shape ({fwd_ms / causal_ms:.3f} of it; the window's "
        f"tiles are 150 of 528 a (b, h))")
    if not fwd_ms <= 0.5 * causal_ms:
        raise AssertionError(f"splash_attn_fwd takes {fwd_ms} ms, more than half the causal "
                             f"flash kernel's {causal_ms} ms: the window's tiles are not skipped")
    del q, k, v, do, o, lse, delta, qs, ks, vs, out, keep
    torch.cuda.empty_cache()

    blockmask = _tpu_attention_blockmask(np, 1024, 256)
    mask = SplashMask.blocks(blockmask, 256, causal=True)
    keep = mask.dense(dev)
    q, k, v = _attn_inputs(torch, g, dev, 2, 4, 1024, 128, torch.bfloat16)[:3]
    n = q.numel() * 2
    with torch.inference_mode():
        res["splash_attn_fwd blocksparse"] = dict(
            ms=_time_ms(torch, lambda: ac.splash_attn_fwd(q, k, v, mask), iters=10),
            plain_ms=_time_ms(torch, lambda: plain.splash_attn_fwd_plain(q, k, v, keep),
                              iters=3, warmup=1),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep), iters=10),
            causal_flash_ms=_time_ms(torch, lambda: ac.flash_attn_fwd(q, k, v), iters=10),
            bound=_bound(4 * n + 2 * 4 * 1024 * 4, 4 * 2 * 4 * int(keep.sum()) * 128),
        )
    del q, k, v, keep
    torch.cuda.empty_cache()

    # The forward and the backward at head_dim 256, the clustered wide bodies
    # (rows @256): B=4, H=8, L=2048, f32, window 256, against SDPA's forward
    # and backward with the dense mask.
    b, h, l, d = 4, 8, 2048, 256
    mask = SplashMask.local(l, WIN_W)
    keep = mask.dense(dev)
    q, k, v, do = _attn_inputs(torch, g, dev, b, h, l, d, torch.float32)
    n, stats = q.numel() * 4, b * h * l * 4
    kept_ops = b * h * int(keep.sum()) * d
    o, lse = ac.splash_attn_fwd(q, k, v, mask)
    delta = plain.attention_delta(o, do)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
    sdpa_bwd = _time_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                           retain_graph=True), iters=10)
    plain_bwd = _time_ms(torch, lambda: plain.splash_attn_bwd_plain(q, k, v, o, lse, do, keep),
                         iters=3, warmup=1)
    with torch.inference_mode():
        res["splash_attn_fwd@256"] = dict(
            ms=_time_ms(torch, lambda: ac.splash_attn_fwd(q, k, v, mask), iters=10),
            plain_ms=_time_ms(torch, lambda: plain.splash_attn_fwd_plain(q, k, v, keep),
                              iters=3, warmup=1),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep), iters=10),
            bound=_bound(3 * n + n + stats, 4 * kept_ops),
            tc_bound=_tc_bound(4 * kept_ops),
        )
        res["splash_attn_bwd_dkv@256"] = dict(
            ms=_time_ms(torch, lambda: ac.splash_attn_bwd_dkv(q, k, v, do, lse, delta, mask),
                        iters=10),
            plain_ms=plain_bwd, library_ms=sdpa_bwd,
            bound=_bound(4 * n + 2 * stats + 2 * n, 8 * kept_ops),
            tc_bound=_tc_bound(8 * kept_ops),
        )
        res["splash_attn_bwd_dq@256"] = dict(
            ms=_time_ms(torch, lambda: ac.splash_attn_bwd_dq(q, k, v, do, lse, delta, mask),
                        iters=10),
            plain_ms=plain_bwd, library_ms=sdpa_bwd,
            bound=_bound(4 * n + 2 * stats + n, 6 * kept_ops),
            tc_bound=_tc_bound(6 * kept_ops),
        )
        res["splash_attn_bwd_dq@256"]["pair_ms"] = (res["splash_attn_bwd_dkv@256"]["ms"]
                                                    + res["splash_attn_bwd_dq@256"]["ms"])
    del q, k, v, do, o, lse, delta, qs, ks, vs, out, keep
    torch.cuda.empty_cache()
    return res


def _time_long(torch, g):
    """The long kernels at the dna path's shapes (B=1, H=256, L=2^20, N=2^21,
    bf16, ungated). Bounds count what each function needs: its inputs read
    once and its outputs written once, against its f32 operations (radix-2
    line DFTs at 5 n log2 n, 6 a point for each twiddle, 20 a point for the
    split and unsplit, 6 for the product). The complex64 bands that only
    this design moves through device memory are reported as overhead_ms."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(DNA_N_FFT, torch.bfloat16, device=dev)
    k, u = _long_inputs(torch, g, dev)
    m, h, length = plan.inner, DNA_D_MODEL, DNA_L_MAX
    lf, lr = math.log2(plan.outer), math.log2(plan.band)
    outer_flops = h * m * (5 * lf + 6 * plan.n_outer)  # outer DFT, its twiddles
    band_flops = h * m * (5 * lr + 6 * (len(plan.sub.factors) - 1))  # one band FFT a point
    bands_bytes = h * m * 8
    res = {}
    with torch.inference_mode():
        k_f = monarch_cuda.long_spectrum(plan, k)
        z = monarch_cuda.butterfly(plan, u)
        fwd = lambda: monarch_cuda.butterfly(plan, u)
        inv = lambda: monarch_cuda.butterfly(plan, z, inverse=True, length=length, dtype=u.dtype)
        # butterfly, either direction: the reals on one side, the bands on the other
        res["butterfly"] = dict(
            ms=_time_ms(torch, fwd, iters=10),
            inverse_ms=_time_ms(torch, inv, iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.butterfly_plain(plan, u), iters=2, warmup=1),
            library_ms=None,
            bound=_bound(u.numel() * 2 + bands_bytes, outer_flops),
        )
        # the forward butterfly on the f32 taps, long_spectrum's first stage
        res["butterfly@f32"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.butterfly(plan, k[None]), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.butterfly_plain(plan, k[None]), iters=2,
                              warmup=1),
            library_ms=None,
            bound=_bound(k.numel() * 4 + bands_bytes, outer_flops),
        )
        # the band kernel: bands in and out, k_f in; two band FFTs a point
        res["long_conv"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv_inner(plan, z, k_f), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_conv_inner_plain(plan, z, k_f),
                              iters=2, warmup=1),
            library_ms=None,
            bound=_bound(2 * bands_bytes + k_f.numel() * 8, 2 * band_flops + h * m * 26),
        )
        del z
        # long_conv as a whole: u and k_f in, y out; the bands cross device
        # memory four times (written and read on each side of the band kernel)
        conv_flops = 2 * (outer_flops + band_flops) + h * m * 26

        def fft_conv():
            return torch.fft.irfft(torch.fft.rfft(u.float(), n=DNA_N_FFT) * k_f,
                                   n=DNA_N_FFT)[..., :length].to(u.dtype)

        res["long_conv_chain"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv(plan, u, k_f), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.conv_with_spectrum(plan, u, k_f), iters=2,
                              warmup=1),
            library_ms=_time_ms(torch, fft_conv, iters=5),
            bound=_bound(u.numel() * 2 * 2 + k_f.numel() * 8, conv_flops),
            overhead_ms=4 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
        # long_spectrum, the chain forward butterfly + its band kernel: f32
        # taps in, half spectrum out; the bands cross twice. Beside it the
        # band kernel alone on the butterfly's bands (bands in, spectrum out:
        # one band FFT and the split a point), and each one's device time.
        zk = monarch_cuda.butterfly(plan, k[None])[0]
        kf_out = torch.empty_like(k_f)
        chain = lambda: monarch_cuda.long_spectrum(plan, k)
        band_kernel = lambda: monarch_cuda._long_spectrum_bands(plan, zk, kf_out)
        rfft = lambda: torch.fft.rfft(k, n=DNA_N_FFT)
        res["long_spectrum"] = dict(
            ms=_time_ms(torch, chain, iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_spectrum_plain(plan, k), iters=2,
                              warmup=1),
            library_ms=_time_ms(torch, rfft, iters=5),
            bound=_bound(k.numel() * 4 + k_f.numel() * 8, outer_flops + band_flops + h * m * 10),
            overhead_ms=2 * bands_bytes / HBM_BYTES_PER_S * 1e3,
            device_ms=_graph_ms(torch, chain, iters=5),
            library_device_ms=_graph_ms(torch, rfft, iters=5),
            kernel_ms=_time_ms(torch, band_kernel, iters=10),
            kernel_device_ms=_graph_ms(torch, band_kernel, iters=5),
            kernel_bound=_bound(bands_bytes + k_f.numel() * 8, band_flops + h * m * 10),
        )
        del zk, kf_out
        # The band kernel of the long backward (ungated, as on the main
        # path): both band arrays and k_f in, du's bands and one dk spectrum
        # out (at B = 1 the partials are that spectrum); three band FFTs a
        # point, two splits, one unsplit and two products a frequency.
        dout = torch.randn(u.shape, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev).to(u.dtype)
        zu, zg = monarch_cuda.butterfly(plan, u), monarch_cuda.butterfly(plan, dout)
        spec_bytes = k_f.numel() * 8
        res["long_conv_bwd"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f),
                        iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_conv_bwd_inner_plain(plan, zu, zg, k_f),
                              iters=1, warmup=1),
            library_ms=None,
            bound=_bound(3 * bands_bytes + 2 * spec_bytes, 3 * band_flops + h * m * 42),
        )
        # gated (y wanted): both band arrays and k_f in, du's and y's bands and
        # the dk spectrum out; four band FFTs a point, one more unsplit and
        # product a frequency
        res["long_conv_bwd@gated"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f,
                                                                         need_y=True), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_conv_bwd_inner_plain(
                plan, zu, zg, k_f, need_y=True), iters=1, warmup=1),
            library_ms=None,
            bound=_bound(4 * bands_bytes + 2 * spec_bytes, 4 * band_flops + h * m * 62),
        )
        parts = monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f)[2]
        del zu, zg
        # long_dk_finish: one dk spectrum in, f32 dk out; the unsplit, one
        # band FFT and the outer stage a point. The dk bands between its band
        # kernel and the inverse butterfly are the design's own traffic.
        res["long_dk_finish"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_dk_finish(plan, parts, length), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_dk_finish_plain(plan, parts, length),
                              iters=1, warmup=1),
            library_ms=_time_ms(torch, lambda: torch.fft.irfft(parts.sum(0), n=DNA_N_FFT)[
                ..., :length], iters=5),
            bound=_bound(spec_bytes + h * length * 4, outer_flops + band_flops + h * m * 10),
            overhead_ms=2 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
        # long_dk_finish's kernel alone: the dk spectrum in, its bands out
        # (the unsplit and one band FFT a point); beside it the plain
        # version of the same step
        zk = torch.empty(h, plan.outer, plan.band, dtype=torch.complex64, device=dev)
        dk_kernel = lambda: monarch_cuda._long_dk_finish_bands(plan, parts, zk)
        dk_plain = lambda: monarch.monarch_idft(
            plan.sub, monarch._natural_to_bands(plan, monarch._unsplit(plan, parts.sum(0))))
        res["long_dk_finish@kernel"] = dict(
            ms=_time_ms(torch, dk_kernel, iters=10),
            plain_ms=_time_ms(torch, dk_plain, iters=1, warmup=1),
            library_ms=None,
            bound=_bound(spec_bytes + bands_bytes, band_flops + h * m * 10),
        )
        del parts, zk
        # The whole long backward of one conv as FftConvFunction runs it: u,
        # dout and the f32 taps in, du and f32 dk out; five M-point FFTs a
        # row. Bands, k_f and the dk spectrum cross device memory 14 times
        # between the kernels (written and read: the taps' bands, k_f, the
        # bands of u and of dout, du's bands, P, dk's bands).
        def long_bwd():
            kf = monarch_cuda.long_spectrum(plan, k)
            du, _, _, parts = monarch_cuda.long_conv_bwd(plan, u, kf, None, None, dout)
            return du, monarch_cuda.long_dk_finish(plan, parts, length)

        def plain_bwd():
            kf = monarch.long_spectrum_plain(plan, k)
            du, _, _, parts = monarch.conv_bwd_plain(plan, u, kf, None, None, dout)
            return du, monarch.dk_finish_plain(plan, parts, length)

        def fft_bwd():
            kf = torch.fft.rfft(k, n=DNA_N_FFT)
            g_f = torch.fft.rfft(dout.float(), n=DNA_N_FFT)
            du = torch.fft.irfft(g_f * kf.conj(), n=DNA_N_FFT)[..., :length].to(u.dtype)
            del kf
            g_f = g_f * torch.fft.rfft(u.float(), n=DNA_N_FFT).conj()
            return du, torch.fft.irfft(g_f.sum(0), n=DNA_N_FFT)[..., :length]

        del k_f
        res["long_bwd_chain"] = dict(
            ms=_time_ms(torch, long_bwd, iters=5, warmup=1),
            plain_ms=_time_ms(torch, plain_bwd, iters=1, warmup=1),
            library_ms=_time_ms(torch, fft_bwd, iters=5, warmup=1),
            bound=_bound(u.numel() * 2 * 3 + k.numel() * 4 * 2,
                         5 * (outer_flops + band_flops) + h * m * 62),
            overhead_ms=14 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
    log(f"timing butterfly inverse: {res['butterfly']['inverse_ms']:.4f} ms (the row's ms is "
        "the forward's)")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out-dir", default="", help="write all numbers to DIR/chip_smoke.json")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if unknown := set(phases) - set(PHASES) - set(OPT_IN_PHASES):
        ap.error(f"unknown phases {sorted(unknown)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    if not (HERE / "flashfftconv_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no flashfftconv_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import flashfftconv_tpu_torch as ff

    if Path(ff.__file__).resolve().parent != HERE / "flashfftconv_tpu_torch":
        print(f"chip_smoke: imported the package from {ff.__file__}, not from {HERE}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(args.seed)

    results = {}
    identity = phase_identity(torch)
    results["identity"] = identity
    if "build" in phases:
        results["build"] = phase_build()
    if "kernels" in phases:
        results["kernels"] = phase_kernels(torch, g)
    if "serve" in phases:
        results["serve"] = phase_serve(torch, args.seed, np)
    if "train" in phases:
        results["train"] = phase_train(torch, args.seed, np)
    if "seq_train" in phases:
        results["seq_train"] = phase_seq_train(torch, args.seed, np)
    if "parity" in phases:
        results["parity"] = phase_parity(torch, args.seed)
    if "grad_parity" in phases:
        results["grad_parity"] = phase_grad_parity(torch, args.seed)
    if "dna" in phases:
        results["dna"] = phase_dna(torch, args.seed, np)
    if "dna_train" in phases:
        results["dna_train"] = phase_dna_train(torch, args.seed, np)
    if "long_parity" in phases:
        results["long_parity"] = phase_long_parity(torch, args.seed, np)
    if "bert" in phases:
        results["bert"] = phase_bert(torch, args.seed, np)
    if "bert_train" in phases:
        results["bert_train"] = phase_bert_train(torch, args.seed, np)
    if "bert_parity" in phases:
        results["bert_parity"] = phase_bert_parity(torch, args.seed, np)
    if "gpt_serve" in phases:
        results["gpt_serve"] = phase_gpt_serve(torch, args.seed, np)
    if "gpt_train" in phases:
        results["gpt_train"] = phase_gpt_train(torch, args.seed, np)
    if "gpt_parity" in phases:
        results["gpt_parity"] = phase_gpt_parity(torch, args.seed, np)
    if "window_serve" in phases:
        results["window_serve"] = phase_window_serve(torch, args.seed, np)
    if "window_train" in phases:
        results["window_train"] = phase_window_train(torch, args.seed, np)
    if "window_parity" in phases:
        results["window_parity"] = phase_window_parity(torch, args.seed, np)
    if "h3_serve" in phases:
        results["h3_serve"] = phase_h3_serve(torch, args.seed, np)
    if "h3_train" in phases:
        results["h3_train"] = phase_h3_train(torch, args.seed, np)
    if "listops_train" in phases:
        results["listops_train"] = phase_listops_train(torch, args.seed, np)
    if "mixers_parity" in phases:
        results["mixers_parity"] = phase_mixers_parity(torch, args.seed, np)
    for name in ("vit_serve", "vit_train", "vit_parity", "attn_bert", "attn_bert_train",
                 "attn_bert_parity", "moe_train", "moe_parity", "sparse_parity"):
        if name in phases:
            results[name] = globals()[f"phase_{name}"](torch, args.seed, np)
    if "harness" in phases:
        results["harness"] = phase_harness(torch, args.seed, np)
    if "lm_cli" in phases:
        results["lm_cli"] = phase_lm_cli(torch, np, results.get("train"))
    if "cli_smoke" in phases:
        results["cli_smoke"] = phase_cli_smoke(torch)
    if "parallel_train" in phases:
        results["parallel_train"] = phase_parallel_train(torch, args.seed, np,
                                                         results.get("train"))
    if "ultra_long_cli" in phases:
        results["ultra_long_cli"] = phase_ultra_long_cli(torch, np)
    if "smem_probe" in phases:
        results["smem_probe"] = phase_smem_probe(torch, args.seed)
    if "timing" in phases:
        results["timing"] = phase_timing(torch, g)
    if "profile" in phases:
        results["profile"] = phase_profile(torch, args.seed)
    if _MESH:
        torch.distributed.destroy_process_group()

    results["versions"] = {"python": sys.version.split()[0], "torch": torch.__version__,
                           "cuda": torch.version.cuda}
    if args.out_dir:
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1, default=str))

    if JSON_PHASES <= set(phases):
        rows = []
        for name, meta in KERNELS.items():
            t = results["timing"][name]
            path = LAUNCH_PHASE.get(name, "train")
            rows.append({
                "name": name, "route": "cuda", **meta,
                "launches": results[path]["launches"][name],
                "max_abs_err": results["kernels"][name],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            })
        print(json.dumps({"kernels": rows}))
    print(identity["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": identity["device"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
