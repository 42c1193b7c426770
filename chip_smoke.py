"""On-card smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one CUDA GPU, nvcc and the repository checkout around this file.
Phases (one JSON line each, with its seconds):

  env       nvidia-smi name and power limit, torch/CUDA/nvcc versions,
            whether the native host codecs loaded, the kernel build time.
  kernels   every CUDA kernel against its plain PyTorch version on the card,
            at the main paths' shapes: the read encoding (csrc/encode.cu,
            both entries: the two-half rows, qv2 and qsum of the v2 passes,
            the v1 composite rows and qv) over a 32,768-read 3p chunk and a
            32,768-read 5p chunk (fresh content each call; device_ms,
            burst_ms, the bound and its share; the host us of a whole chunk
            encode, `encode_call`, split into join, stage, upload, kernel
            and download, beside the numpy `encode_two_half` on the same
            reads), over its edge set (encode_edge_reads: every length
            class around E and 2E, every byte value in sequences and
            qualities, qualities shorter and longer than their read) in one
            launch and in spans of 1, 36 and the rest (rebased offsets),
            through the pinned and the pageable staging, each also against
            the numpy oracles, and the wrappers' refusals; over
            encode_shape_reads (lengths around 0, E, 2E and 3E in a row, L
            = 0 beside Lq = 0, L > 2E with Lq <= 2E and the reverse) with
            seq and qual starting 0-15 bytes past a 16-byte boundary, and
            over the chunk's first B reads for B of 1, 2 and around the
            grid's warps (encode_layout_cases); its kernels' registers,
            spills and shared memory and the SASS of their read loop
            (encode_kernel_usage); the edge scan over a 32,768-read 3p
            chunk and a 32,768-read 5p chunk (encode_two_half's rows [B, 2E]
            as they are), and over the edge set (edge_set_reads: lengths 0,
            under k, E, 2E and over 2E, all-N reads, runs at win_p and at
            word borders, adapter windows off both read ends; 3p and 5p,
            launches of 1, 37, 129 reads and all), the whitelist sweep of
            its BC windows against 8,192 and 49,152 barcodes, the chimera
            scan over all tiles of the chunk; the tile feed over the 3p
            chunk's covered reads (the fused route's index; rows
            byte-equal to `tile_feed_plain`) and over the feed edge set
            (feed_edge_reads: lengths around E, 315 and 608, N, lowercase,
            NUL and other bytes, short chimeras; launches of 1, 37 and all,
            each with the covered reads' index and with every read's),
            rows at an unaligned offset must raise, and the chimera scan
            over the feed's rows of the chunk; the band aligner
            over 8,192 pairs at (Lc = 512, W = 32), 8,192 at (Lc = 1,024, W
            = 64) and 256 at (Lc = 2,048, W = 64); the window search over
            the 5p adapter windows of two chunk halves [65,536, 110], the
            complete-adapter windows [32,768, 110], the 5p TSO windows
            [32,768, twin] and six confirm windows a tile [6 x tiles, 160],
            plus B = 1 and B = 37 with an all-PAD row, and on rows whose
            data starts 0-15 bytes past a 16-byte boundary
            (WIN1_EDGE_SHAPES); the chimera scan also on edge tiles
            (tile_edge_rows: 0, 1, 3 and 5 runs a direction, sites at
            own_lo, own_hi - 1 and tlen - k, confirm windows off both tile
            ends, an all-PAD tile) in launches of 129 and 1 tiles.
            `wrapper_host_us`: the host time of one `myers_win1`, one
            `tile_scan` and one 3p and one 5p `edge_scan2` call. The sweep
            runs with and without the end position (the main path asks for
            none), also over 4,096 reads (a small launch must keep the card
            full), on small cases that its barcode slices could get wrong
            (SWEEP_EDGE_CASES) and its merge kernel alone against
            `merge_sweep_partials_plain`; the band aligner also on pair sets
            with infeasible, band-edge and empty pairs and a center of
            length 0 (BAND_EDGE_SHAPES), with both forms of its prefix
            maximum, and at the aligner's gap buckets (GAP_SHAPES: Lc 64,
            128 and 256 at W 32, pairs as `GapBatcher` builds them, each its
            own molecule, with infeasible and empty ones).
            The UMI distance matrix kernel (`myers_global_group`, a group's
            raw bytes in) against its plain version (on the card: the bytes
            mapped by dna._ENC, Peq by tensor ops, the per-length loop over
            `myers_global_pairwise`) on five groups (umi_groups): 256 UMIs
            of 12 nt and 32 of 16 nt, 176 of mixed lengths with N, an empty
            and 33-nt UMIs (host rows), 3,000 of 10-14 nt, 8,192 of 12 nt
            with 3% of 11 or 13 nt (a group above the single-link switch)
            and one holding every byte value; the whole group call
            (`_pairwise_ed_device`) against the CPU's (the 8,192 group:
            against the plain matrix), its host us at 288, 3,000 and 8,192
            UMIs split into host preparation, upload, launch and kernel,
            download and host rows (`group_call_split`), beside the
            kernel's device_ms, and the wrapper's refusals of
            wrong dtypes, offsets and alignment. Tolerance: exact (integer
            outputs; mismatches must be 0). Median ms of each over >= 5
            timed calls (CUDA events), each call on freshly mutated
            content; `device_ms` is the device time of a call's launches
            with no host time in it (CUDA events around calls queued behind
            a spin kernel),
            `burst_ms` the mean of back-to-back calls as the host issues
            them (edge scan, band aligner, tile scan, window search). Beside
            each time stands the kernel's bound on this card (see BOUNDS
            below); a kernel faster than its bound ends the run. The
            composed edge body (torch ops + three window searches; the route
            of configs outside the fused kernel's envelope) is timed on the
            5p chunk beside the fused kernel, with a sync-timed split of one
            call by scan op.
  pipeline  `ScanFastqPipeline.run` on `cuda` over a synthetic run of
            131,072 reads in 4 fastq files (8,192 cells drawn from a
            65,536-barcode whitelist; 4% error, ~6% 2-8 kb reads, ~2%
            chimeras, ~2% garbage, ~1% with N near an end), cached pass 1,
            32,768-read chunks. Launch counts are zeroed just before and
            read just after: every kernel must have launched, the read
            encoding (every v2 pass encodes on the card) and the tile feed
            included (the cached pass 1 on one card scans the interiors of
            the reads of 316-608 bases from its own upload; the tile scan
            then runs once on the feed's rows and once on the host tiles of
            the residue, a chunk: both counts are printed), no plain body
            may have run.
  parity    the same pipeline on a 4,096-read subset on `cuda` and on `cpu`
            (plain bodies): every output file byte-identical, and assigned
            barcodes agreeing with the generator's truth. The `cuda` run
            takes the fused tile route (the feed must launch), the `cpu` run
            the host tiles, so the bytes also hold fused == host.
  pipeline_5p  the same run with `PipelineConfig(chemistry="5p")` over
            131,072 synthetic 5p reads (`synth.make_read_5p`, the same mix):
            the fused edge kernel (every launch with 5p parameters, by the
            wrapper's own 5p count), the sweep, the tile feed and the tile
            scan must have launched; the window search, the composed body
            and every plain version not.
            Then the CUDA-vs-CPU byte parity on a 4,096-read subset.
  v1_control  the random-barcode negative control (`random_barcode=True`,
            fixed seed, max ED 1) over one 3p file of 32,768 reads on `cuda`:
            the synchronous pass 2 (`pass2_chunk`: `split_chimeras`, the v1
            composite scan `scan_reads`, whose composite rows the encode
            kernel's second entry writes, `bc_search`). The falsely assigned
            share of the stranded reads must be under 5%; CUDA == CPU bytes
            on a 4,096-read subset with the same seed.
  scanfastq_split  the 3p, 5p and control runs once more, each with a timer
            (and a device sync) around every stage: seconds by stage (the
            read encoding as join, stage, upload and kernel, the downloads
            apart; the host tile build of the residue, `build_tiles`, apart
            from the tile feed).
  empty_used_list  a whitelist that shares no barcode with the reads, on
            `cuda` and `cpu`: pass 1 finds nothing, pass 2 is `pass2_chunk`,
            nothing is assigned, the bytes agree.
  prefilter  the q-gram prefilter search
            (`prepare_search(mode="prefilter")` + fused scan/search) against
            the brute sweep mode on the card: equal ed and idx wherever the
            sweep's best ED lies within the radius, not-found beyond it.
  consensus `compute_consensus` on `cuda` over a synthetic tagged BAM of
            32,768 molecules (50% one read, 20% two, 30% 3-12 reads;
            400-900 nt cDNA at 3% error; ~1% of the multi-read molecules
            with an N; four over 2,048 nt), written with the port's
            BamWriter. Launch counts are zeroed just before and read just
            after: the band kernel must have launched, no plain version
            may have run. Molecules and UMIs/s; a sample of multi-read
            consensuses must lie within 2% edit distance of their truth.
            A second, instrumented run (timers with a device sync around
            each stage) gives the split of the phase's time.
  consensus_parity  the same consensus on a 2,048-molecule subset on `cuda`
            and on `cpu`: output fastq and stats byte-identical.
  mesh      the `pipeline` phase's run (131,072 3p reads, cached pass 1)
            with `ScanFastqPipeline(mesh=...)` and the `consensus` phase's
            BAM with `BatchedConsensusEngine(mesh=...)`: two shards on
            cuda:0 on a one-card machine (they share its stream: right, but
            serial), one a card where more are visible. Every output file
            must equal those phases' bytes. Launch counts are zeroed just
            before each run and read just after, and `ShardLaunches`
            attributes them to shards: the edge scan, the sweep and the
            tile scan (scan) and the band kernel (consensus) must have
            launched on every shard, no plain body, window search or
            composed edge body anywhere, and no tile feed (with a mesh the
            cached pass 1 takes the host tiles, as the JAX package does).
            Reads/s and UMIs/s beside the single-device rates.
  multiprocess  the same scan in two processes joined by a gloo group
            (`parallel.multihost`) on the card, each started as `python -c
            MP_RANK` with a timeout and scanning files[rank::2] of the same
            4 files: the union of their passed/ and failed/ files and
            BarcodeList.tsv equal the `pipeline` phase's bytes, the merged
            scanner_stats.json its stats, and BarcodesAssigned.tsv its rows
            with tied barcodes in used-list order (the JAX merge's order);
            each rank must launch the three scan kernels and the tile feed
            and no plain body, and no edge scan with 5p parameters
            (counted apart, as in `run`).
  steps_1_to_4b  Steps 1 -> 2 -> 3 -> 4b chained on `cuda` (chain_steps):
            scanfastq -> align (the spliced aligner; its gap extension
            runs the band kernel) -> assignumis with the refFlat (UMI
            distances of groups of 48 unique UMIs or more on the card) ->
            tagbamwithread -> computeconsensus, over a synthetic genome (two
            4 Mb contigs, 1,000 genes of one or two exons) and 8,192 3p
            reads of 16 cells: 64 (cell, gene) groups of 64-80 molecules,
            the rest of 1-8 molecules at 1-4 reads (chain_genome,
            chain_reads). Launch counts are zeroed before each step and read
            after it: the aligner and computeconsensus must launch the band
            kernel, assignumis the pairwise kernel once a batched group (the
            recorded `_pairwise_ed_device` calls), no plain body may run.
            Reads/s of align, records/s of assignumis, a split of both
            (timers around the methods, a device sync around the device
            parts), which native host codecs the aligner took, and the
            shares of primary records inside their true gene and carrying it
            as GE (CHAIN_MIN_SHARE). Its CUDA == CPU parity on a subset of
            about 1,024 reads is split: the `run` phase's subset run covers
            Steps 1-3, and `steps_4b_parity` Step 4b.
  run       the workflow through the port's CLI in this process (`python -m
            sicelore_tpu_torch run -b 2 --nativeAlign --collapse --device
            cuda`, run_workflow) over the chained phase's genome, refFlat,
            whitelist (as a file) and reads: scanfastq -> align ->
            assignumis -> barcodes -> isoformmatrix (with the isobam) ->
            collapsemodel. Launch counts are zeroed just before and read
            just after: the edge scan, the sweep, the tile feed, the tile
            scan, the band kernel and the pairwise kernel (once a batched
            group) on the card must have launched, no plain body, composed
            edge body or window search. The edge launches made with 5p
            parameters are counted apart (the kernels line's
            `launches_run_5p`). Each stage's seconds (from the stage lines
            `run` prints), align reads/s, the gene matrix's genes and cells
            and the shares of chain_truth.
            Then `run ... --consensus` on the parity subset on `cuda` and on
            `cpu` (the consensus stage runs the host engine, as the
            reference package's `run` does): every file byte-identical; then
            the same CUDA run on its own output: all eight stages resume and
            nothing launches.
  steps_4b_parity  tagbamwithread and computeconsensus (the device engine)
            on each device's subset run of the `run` phase: umi_us.bam,
            consensus.fastq and its log byte-identical.
  precompile  `python -m sicelore_tpu_torch precompile` in its own
            process: exits 0 and prints one warm time for each kernel.

`python3 chip_smoke.py --kernels-only` stops after the `kernels` phase (for
iterating on a kernel; it prints no ok line).

Then: a short {"summary": ...} line (the end-to-end rates, the consensus
split and the script's seconds), the {"kernels": [...]} line, the nvidia-smi
line, and last
{"ok": true, "device": {...}}. Any failure raises: no ok line, exit != 0.

BOUNDS. `bound_ms` is the least time this card could take for a kernel's
work at this run's inputs: the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its int32 operations over
the card's SM count (read from the device; 132 on an H100 SXM) x 128 lanes
x the card's maximum SM clock (nvidia-smi clocks.max.sm): what an SM's four
schedulers can dispatch, which two integer pipes of 64 lanes each (ALU and
FMA/IMAD) can fill together. Counting one pipe (64 lanes an SM) is no
bound: a kernel of this package ran at 1.6 times it.
Operation counts, from the kernels' own arithmetic:
  Myers column (csrc/myers.cuh myers_step): 18, the count the JAX
    package's bench.py uses for the same step (the step's 21 C operators
    less the three NOTs, which fold into three-input logic operations).
  edgescan, a read (edge_scan_work, from this run's reads; held to a
    direct count by tests/test_torch_edgescan_words.py):
    - the two run scans, each read from its read end (the head for T, the
      tail backwards for A) up to where it decides: the first start whose
      window is not passing after the run, or the last start below win_p
      (and inside the read) when there is no run, plus k - 1 columns;
      counted in 32-column words of the word form (csrc/edgescan.cu), the
      cheapest form this package knows, a three-input logic operation as
      one, k = 15: the base mask 49 (a 4-code word: xor, add, and, the
      bit-gathering multiply, shift; seven merges; the not and the read
      limit), the window test 54 (doublings to 2, 4, 8 columns 3 + 6 + 9,
      the 4-, 2-, 1-column sums added at their offsets 11 + 11 + 10, the
      carry test 4): 103 a word, where the scalar scan takes 6 a column
      (192 a word).
    - the Myers searches over their window columns inside the read only
      (a column outside holds PAD: it leaves the state as it is before the
      first code and lowers no score after the last), 18 a
      column: the sense adapter window of each side whose run was found
      (5p: the REV side's always, its end column is ROW_AE), the chosen
      complete-adapter window, the TSO window.
    - the complete adapter's longest run, a column of that window: the
      least of the threshold-word form over the levels these data need
      (2 a level, levels = the run found + 1, at most m), the bit-sliced
      counter of csrc/edgescan.cu (EDGE_RUN_BITSLICE_OPS: five shifts, the
      five planes' increment and reset 8, the test against best + 1 five
      majorities, the best's mask 2 and its decrement 9: 29) and the
      scalar form (3 a pattern row).
    - the TSO bailout, a column of the TSO window: 2 a threshold level
      over the levels these data need (the window's longest run + 1, at
      most c1) and 2 a threshold pair.
    Bytes: the columns those scans and windows read (their union on each
    half), 4 a read of lens and the output rows.
  bcsweep: reads x barcodes x window columns x 18.
  tilescan: the word form of the detection (csrc/tilescan.cu), the
    cheapest form this package knows, counted with a three-input logic
    operation as one, a 32-column word (a lane), both directions, k = 15
    (the default and this run's): the A and T masks 86 (two shifts, then
    for each mask two logic operations and a compaction of seven, a mask
    and eight columns; three byte merges a mask); the window test 54 a
    direction (doublings to 2, 4 and 8 columns, a funnel shift and two
    logic operations a plane: 3 + 6 + 9; the 8-column sum taken as it is;
    the 4-, 2- and 1-column sums added at offsets 8, 12 and 14 with their
    shifts: 11 + 11 + 10; the carry test against mc: 4); the span mask and
    the two ands 10; the rising edges 6: 210 a word, where the scalar scan
    takes 6 a column and direction (384 a word). Shuffles, ballots and the
    per-tile site walk are not counted. Words: those holding a window
    start in [own_lo, min(own_hi, tlen - k + 1)) or a column such a
    window reads (tile_scan_work), not all 32. Confirms: the sites the
    plain detection finds x WI_CONFIRM (160) columns x 18. Bytes: the
    same work, not whole rows: the 16 meta bytes of every tile, the bytes
    (two columns each) of the union of the columns those windows read and
    the confirm windows' columns inside [0, tlen) (the rest is PAD, known
    from tlen), and the [3, T] int32 output.
  encode (both entries): no operations worth a bound (it moves bytes;
    its read loop issues about 17 instructions a lane a column of both
    streams, 3.4e8 for a 32,768-read chunk, under half the byte time):
    bytes only, the bytes of each
    read and of its quality string that a row takes (min(L, 2E) and
    min(Lq, 2E): a two-half row's head and tail overlap below 2E), the
    two int64 offset arrays, and the [B, 2E] codes and qv rows written
    (and qsum, 4 a read, of the two-half entry).
  tilefeed: no operations worth a bound (it moves bytes): bytes only, the
    code bytes its covered reads' tiles need (L of each read with 315 < L
    <= 608: its first min(L, E) and its last L - E columns), 4 a covered
    read of index and 4 of its length, and the [C, 528] output rows of
    the C covered reads.
  pairwise: a (pattern row of 1..32 nt, text) pair is len(j) global
    Myers columns of 16 and the distance read from the last column, 4
    (pairwise_work): the column keeps no score, unlike win1's and the
    sweep's 18; bytes: the group's raw bytes and its K + 1 int32 offsets
    read once, the [K, K] int32 matrix written once.
  win1: windows x columns x 18; the kernel's column step takes more
    instructions than that (the Myers step, its two match-mask lookups
    a pair of columns and the keyed best), so 18 stays the count.
  bandalign: sum over pairs of clen x W band cells x 13, what the
    recurrence needs of a cell whatever the kernel's design: substitution
    compare and select 3, diagonal add 1, vertical add and max 2, gap
    closure (a prefix maximum) 2, clamp 1, the two move tests 4. Lane
    bookkeeping, shuffles and the traceback (1/W of the cells) are not
    counted; clen is this run's, not Lc (at the gap shapes, each pair's
    own ref segment).
No PyTorch call computes any of the nine functions: `library_ms` is
null.
"""
from __future__ import annotations

import ast
import functools
import json
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N_FILES = 4
READS_PER_FILE = 32_768
N_WHITELIST = 65_536
N_CELLS = 8_192
SWEEP_LISTS = (8_192, 49_152)
SWEEP_SMALL_B = 4_096
N_PARITY = 4_096
TIMED_CALLS = 5
SEED = 20_240_601
T_START = time.time()
BAND_PAIRS = 8_192
BAND_SHAPES = ((512, 32, BAND_PAIRS, 300, 490),      # Lc, W, pairs, truth
               (1024, 64, BAND_PAIRS, 520, 900),     # lengths lo, hi
               (2048, 64, 256, 1100, 1900))
BAND_EDGE_SHAPES = ((1, 200, 256, 32), (31, 230, 256, 32),   # pairs, read
                    (203, 480, 512, 32), (57, 900, 1024, 64),  # length, Lc, W
                    (7, 1900, 2048, 64))
CONTROL_SEED = 7
CONTROL_MAX_ED = 1
PREFILTER_RADIUS = 2
N_MOLECULES = 32_768
N_CONS_PARITY = 2_048
# Lc, pairs (W 32): the mean pairs a call of the aligner's buckets in the
# chained phase's align step (2,048 reads a call)
GAP_SHAPES = ((64, 25_823), (128, 2_283), (256, 19))
UMI_GROUP = ((12, 256), (16, 32))   # pattern length, UMIs of that length
UMI_BIG = 8_192             # a group above the single-link switch (3,000)
UMI_BIG_INDEL = 0.03        # its share of 11 or 13 nt UMIs
GROUP_CALLS = {"g288": 200, "g3000": 20, "g8192": 5}   # group calls timed
CHAIN_CONTIGS = 2
CHAIN_CONTIG_LEN = 4_000_000
CHAIN_GENES = 1_000
CHAIN_READS = 8_192         # halved from 16,384: the phase took 107 s
CHAIN_CELLS = 16
CHAIN_WHITELIST = 1_024
CHAIN_BIG_GROUPS = 64
CHAIN_BIG_MOLECULES = (64, 80)
CHAIN_PARITY = 1_024
# the shares of primary records inside their true gene, and carrying it as
# GE: both were 1.0 on the CPU at the parity size (1,022 of 1,022)
CHAIN_MIN_SHARE = 0.97
HBM_BYTES_PER_S = 3.35e12
# int32 lanes a clock: an SM's four schedulers dispatch one warp instruction
# (32 lanes) a clock each, and integer work runs on two pipes side by side
# (the ALU pipe: logic, shifts, min/max, LEA; the FMA pipe: IMAD, which the
# compiler also uses for adds, constant shifts and moves), each 16 lanes a
# scheduler. 64 lanes an SM counted one pipe only, and the redesigned sweep
# ran at 158-171% of that "bound".
INT32_LANES_PER_SM = 128
MYERS_OPS = 18
PAIRWISE_COLUMN_OPS = 16    # a global Myers column that keeps no score
PAIRWISE_PAIR_OPS = 4       # its distance: two popc and two adds a pair
BAND_CELL_OPS = 13
# a band cell of the host engine's alignment (csrc/hostnw.cu): the byte
# compare and its score select, the diagonal and up adds, their maximum,
# the tilt, the prefix maximum, the untilt and the final maximum
HOSTNW_CELL_OPS = 9
HOSTNW_PLAIN_CALLS = 3      # kernel vs plain calls (the plain walk is slow)
TILE_WORD_OPS = 210         # a 32-column word of the tile detection, k = 15
EDGE_WORD_OPS = 103         # a 32-column word of an edge run scan, k = 15
EDGE_RUN_BITSLICE_OPS = 29  # a column of the bit-sliced longest run
EDGE_PAIR_OPS = 2           # a column of one bailout threshold pair
TILE_EDGE_N = 129           # edge tiles: four blocks of 32 and one of 1
HOST_CALLS = 1_000          # wrapper calls timed on the host clock
ENCODE_CALLS = 5            # whole chunk encodes timed
ENCODE_LONG = 4_000         # the encode edge set's longest read
SPIN_CYCLES = 1 << 24       # device_ms's first spin: ~8.5 ms at 1.98 GHz


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_file(args) -> int:
    """Write one synthetic fastq file (worker process). Read names carry
    the truth: r<i>c<cell index>, x<i> chimera, g<i> garbage. chem "5p"
    makes 5' reads; its chimeras are two 5' reads joined end to end."""
    path, seed, cells, chem = args
    import numpy as np

    from sicelore_tpu_torch.utils import synth
    rng = np.random.default_rng(seed)
    make_read = synth.make_read_5p if chem == "5p" else synth.make_read

    def make_chimera(bc1, bc2, **kw):
        if chem != "5p":
            return synth.make_chimera(rng, bc1, bc2, **kw)
        a, b = make_read(rng, bc1, **kw), make_read(rng, bc2, **kw)
        return {"seq": a["seq"] + b["seq"], "qual": a["qual"] + b["qual"]}
    with open(path, "wb") as fh:
        for i in range(READS_PER_FILE):
            u = rng.random()
            ci = int(rng.integers(0, len(cells)))
            rev = bool(rng.random() < 0.5)
            if u < 0.06:
                name = f"r{i}c{ci}"
                r = make_read(rng, cells[ci],
                              cdna_len=int(rng.integers(2000, 8000)),
                              error_rate=0.04, reverse=rev)
            elif u < 0.08:
                name = f"x{i}"
                r = make_chimera(
                    cells[ci], cells[int(rng.integers(0, len(cells)))],
                    cdna_len=int(rng.integers(300, 700)), error_rate=0.04)
            elif u < 0.10:
                name = f"g{i}"
                L = int(rng.integers(60, 900))
                r = {"seq": synth.random_seq(rng, L).encode(),
                     "qual": bytes(33 + int(x)
                                   for x in rng.integers(2, 30, L))}
            else:
                name = f"r{i}c{ci}"
                r = make_read(rng, cells[ci],
                              cdna_len=int(rng.integers(300, 700)),
                              error_rate=0.04, reverse=rev)
            seq = bytearray(r["seq"])
            if rng.random() < 0.01 and len(seq) > 0:
                for _ in range(int(rng.integers(1, 4))):
                    p = int(rng.integers(0, min(304, len(seq))))
                    seq[p if rng.random() < 0.5 else len(seq) - 1 - p] = 78
            fh.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), bytes(seq),
                                            r["qual"]))
    return READS_PER_FILE


def timed(fn, variants, sync):
    """Median ms of fn(v) over the variants, CUDA events around each call."""
    import torch
    ms, outs = [], []
    for v in variants:
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(v)
        b.record()
        sync()
        ms.append(a.elapsed_time(b))
        outs.append(out)
    return sorted(ms)[len(ms) // 2], outs


def compare(name, fn_k, fn_p, variants):
    """Kernel vs plain on every variant, alternating which runs first:
    total mismatches, max |kernel - plain|, median ms of each."""
    import torch
    sync = torch.cuda.synchronize
    fn_k(variants[0])
    fn_p(variants[0])              # warm both (library load, allocator)
    sync()
    ms = {"k": [], "p": []}
    mism = maxd = 0
    for i, v in enumerate(variants):
        res = {}
        for tag, fn in ((("p", fn_p), ("k", fn_k)) if i % 2 == 0
                        else (("k", fn_k), ("p", fn_p))):
            t, outs = timed(fn, [v], sync)
            ms[tag].append(t)
            res[tag] = outs[0]
        for k, p in zip(*(r if isinstance(r, tuple) else (r,)
                          for r in (res["k"], res["p"]))):
            if k.shape != p.shape or k.dtype != p.dtype:
                raise SystemExit(
                    f"{name}: kernel {tuple(k.shape)} {k.dtype} vs plain "
                    f"{tuple(p.shape)} {p.dtype}")
            mism += int((k != p).sum())
            if k.numel():
                maxd = max(maxd, int((k.int() - p.int()).abs().max()))
        del res
    med = {t: sorted(v)[len(v) // 2] for t, v in ms.items()}
    return {"mismatches": mism, "max_abs_err": maxd, "ms": med["k"],
            "plain_ms": med["p"], "calls": len(variants)}


def bound(n_bytes: int, n_ops: int, int32_hz: float) -> dict:
    """The least time (ms) this card could take for n_bytes moved and
    n_ops int32 operations at int32_hz of them a second (SMs x
    INT32_LANES_PER_SM x the SM clock), and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / int32_hz * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "operations": int(n_ops)}


def covered_index(lens, p, dev):
    """The fused route's feed index of a chunk: the reads with min_len < L
    <= 2E (`feed_covered`), int32 [C] on `dev`, as
    `ReadScanModel.scan_pass1_full_async` builds it."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    idx = np.nonzero(ts.feed_covered(np.asarray(lens), p))[0]
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


def tile_scan_work(rows, p) -> tuple[int, int, int]:
    """(words, sites, row bytes) of a tile scan over rows [T, 528] uint8:
    the 32-column words holding a window start in a tile's span [own_lo,
    min(own_hi, tlen - k + 1)) or a column such a window reads; the sites
    the plain detection finds (each one Myers confirm); the bytes of the
    rows the output depends on: every tile's 16 meta bytes and the bytes of
    the columns those windows and the sites' confirm windows read inside
    [0, tlen)."""
    import torch

    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    _, own_lo, own_hi, tlen, _, _ = ts._unpack(rows)
    hi = torch.minimum(own_hi, tlen - p.k + 1)
    end = torch.clamp(hi + p.k - 1, max=ts.TILE)
    words = torch.where(hi > own_lo, (end + 31) // 32 - own_lo // 32, 0)
    sA, sT = ts.tile_sites_plain(rows, p)
    # column intervals [lo, hi) a tile reads -> byte intervals, whose union
    # a running sum of +1 / -1 marks counts
    lo = torch.cat([own_lo[:, None], sA, sT - ts.WI_CONFIRM], 1)
    up = torch.cat([end[:, None], sA + ts.WI_CONFIRM, sT], 1)
    live = torch.cat([(hi > own_lo)[:, None], sA >= 0, sT >= 0], 1)
    lo = lo.clamp(min=0)
    up = torch.minimum(up, tlen[:, None])
    live = live & (up > lo)
    marks = torch.zeros((rows.shape[0], ts.TILE // 2 + 1), dtype=torch.int32,
                        device=rows.device)
    marks.scatter_add_(1, torch.where(live, lo // 2, 0), live.int())
    marks.scatter_add_(1, torch.where(live, (up + 1) // 2, 0), -live.int())
    n_bytes = (marks.cumsum(1)[:, :-1] > 0).sum() + ts.TILE_META * len(rows)
    return (int(words.sum()), int((sA >= 0).sum() + (sT >= 0).sum()),
            int(n_bytes))


def edge_set_reads(rng, chem, n=96):
    """Reads whose edges the kernel's words, windows and blocks could get
    wrong: both strands, long and short reads, lengths 0, under k, exactly
    E, 2E and over 2E, all-N reads, polyA/T runs that start or end at the
    search region's limit (win_p) and at 32-column word borders, runs at
    the very read ends (adapter windows running off both ends), N inside
    runs."""
    from sicelore_tpu_torch.ops.edgescan import E
    from sicelore_tpu_torch.utils import synth
    make = synth.make_read_5p if chem == "5p" else synth.make_read
    wl = synth.make_whitelist(rng, 16)
    k, win_p = 15, 150
    seqs = []
    for i in range(n):
        clen = int(rng.integers(40, 600)) if i % 4 else \
            int(rng.integers(900, 2000))
        seqs.append(make(rng, wl[i % 16], cdna_len=clen, error_rate=0.05,
                         reverse=bool(i % 2))["seq"])
    junk = lambda L: synth.random_seq(rng, L).encode()   # noqa: E731
    for L in (0, 1, 7, 14, 15, 16, E - 1, E, E + 1, 2 * E, 2 * E + 1, 700):
        seqs.append(junk(L))
    for L in (20, E, 3 * E):
        seqs.append(b"N" * L)
    # polyT starts around win_p - 1 and word borders (head), polyA ends
    # the same distances from the read end (tail)
    for s0 in (0, 1, 31, 32, 33, 63, 64, win_p - k - 1, win_p - k,
               win_p - 1, win_p, win_p + 1, 160, 250):
        for run in (k - 4, k, k + 1, 40):
            body = bytearray(junk(2 * E + 60))
            body[s0:s0 + run] = b"T" * run
            e = len(body) - s0
            body[max(e - run, 0):e] = b"A" * min(run, e)
            seqs.append(bytes(body[:max(s0 + run + 30, 120)]))
            seqs.append(bytes(body))
    # a run with N inside, and a run at the very end / start of a short read
    s = bytearray(b"T" * 30 + junk(200) + b"A" * 30)
    s[5] = s[-6] = ord("N")
    seqs += [bytes(s), b"T" * 40, b"A" * 40, b"T" * 20 + b"A" * 20]
    quals = [bytes(33 + (j % 40) for j in range(len(x))) for x in seqs]
    return seqs, quals


def feed_edge_reads(rng, n=64):
    """Reads the tile feed could get wrong (3p and 5p, both strands):
    lengths at both sides of E, of min_len (2 x 150 + 15 = 315) and of 2E,
    and outside the feed's range; chimeras of at most 2E bases; reads with
    an N, a lowercase base, another non-ACGT byte or a NUL byte in the
    head, in the tail, in both, and whole lowercase reads. Returns (seqs,
    quals)."""
    from sicelore_tpu_torch.ops.edgescan import E
    from sicelore_tpu_torch.utils import synth
    wl = synth.make_whitelist(rng, 16)
    junk = lambda L: synth.random_seq(rng, L).encode()   # noqa: E731
    seqs = [junk(L) for L in (0, 1, 200, E - 1, E, E + 1, 314, 315, 316,
                              317, 450, 2 * E - 1, 2 * E, 2 * E + 1, 700,
                              1500)]
    for i in range(n):
        make = synth.make_read_5p if i % 2 else synth.make_read
        seqs.append(make(rng, wl[i % 16],
                         cdna_len=int(rng.integers(150, 500)),
                         error_rate=0.04, reverse=i % 3 == 0)["seq"])
    for i in range(n // 4):
        seqs.append(synth.make_chimera(
            rng, wl[i % 16], wl[(i + 5) % 16],
            cdna_len=int(rng.integers(150, 200)), error_rate=0.03)["seq"])
    for i, pos in enumerate((0, 10, E - 1, E, E + 1, 400, -E, -1)):
        for byte in b"NacgtX\x00n":
            s = bytearray(junk(int(rng.integers(max(330, pos + 1),
                                                2 * E + 1))))
            s[pos] = byte
            s[-1 - i] = byte
            seqs.append(bytes(s))
    seqs += [junk(L).lower() for L in (316, 500, 2 * E)]
    return seqs, [bytes(33 + (j % 40) for j in range(len(x))) for x in seqs]


def edge_scan_work(codes, lens, p) -> dict:
    """The work an edge scan of these reads needs (BOUNDS, edgescan):
    {"operations", "bytes", "scan_columns", "window_columns"} from torch
    ops on codes' device. codes [B, 2E] int8 (encode_two_half's rows),
    lens [B]; p: the run's EdgeParams (k = 15, the count of
    EDGE_WORD_OPS)."""
    import torch

    from sicelore_tpu_torch.models.readscan import gather_window
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import scan
    E, k, dev = eg.E, p.k, codes.device
    B = codes.shape[0]
    lens = lens.to(device=dev, dtype=torch.int64)
    hl = lens.clamp(max=E)
    head, tail = codes[:, :E], codes[:, E:]
    meta = eg.edge_scan2_plain(head, tail, lens.int(), p).long()
    cols = torch.arange(E, device=dev)[None, :]
    pos = torch.arange(E - k + 1, device=dev)[None, :]
    lim_p = (hl - k + 1)[:, None]
    scan_cols, first = [], []
    for half, base in ((head, 3), (tail.flip(1), 0)):
        ind = ((half == base) & (cols < hl[:, None])).int()
        cs = torch.nn.functional.pad(ind.cumsum(1), (1, 0))
        passing = ((cs[:, k:] - cs[:, :-k]) >= p.mc) & (pos < lim_p)
        ok = passing & (pos < p.win_p)
        found = ok.any(1)
        j = torch.where(found, ok.int().argmax(1), -1)
        stop_mask = torch.cat([~passing & (pos > j[:, None]),
                               torch.ones_like(passing[:, :1])], 1)
        stop = stop_mask.int().argmax(1)
        n = torch.where(found, stop + k - 1,
                        torch.minimum(torch.full_like(hl, p.win_p),
                                      lim_p[:, 0]) - 1 + k)
        scan_cols.append(torch.where(lim_p[:, 0] > 0, n, 0).minimum(hl))
        after = (ind > 0) & (cols >= j[:, None])
        first.append(torch.where(found, after.int().argmax(1), -1))
    lim = (hl, torch.full_like(hl, E))

    def inside(h, s, W):
        """(first column, columns) of a window inside [0, lim)."""
        a = (-s).clamp(min=0)
        n = (torch.minimum(torch.full_like(s, W), lim[h] - s) - a).clamp(
            min=0)
        return s + a, n

    spans = [[(torch.zeros_like(hl), scan_cols[0])],
             [(torch.zeros_like(hl), scan_cols[1])]]
    win_cols = torch.zeros_like(hl)
    zero = torch.zeros_like(hl)
    ad_cols = 0
    for side in (0, 1):
        hs = (1 - side) if p.is5p else side
        s = zero if p.is5p else first[side] - p.awin
        need = (first[side] >= 0) | (p.is5p and side == 0)
        a, n = inside(hs, s, p.awin)
        n = torch.where(need, n, 0)
        win_cols += n
        ad_cols += int(n.sum())
        spans[hs].append((a, n))
    is_fwd = meta[eg.ROW_IS_FWD] != 0
    us = is_fwd.long()
    uhalf = 1 - us if p.is5p else us
    us_s = zero if p.is5p else torch.where(is_fwd, first[1], first[0]) \
        - p.awin
    n_used = torch.zeros_like(hl)
    for h in (0, 1):
        a, n = inside(h, us_s, p.awin)
        n = torch.where(uhalf == h, n, 0)
        n_used += n
        spans[h].append((a, n))
    t0 = (torch.where(meta[eg.ROW_STRANDED] != 0, meta[eg.ROW_AE], -1)
          + 1 + p.bc_len) if p.is5p else zero
    n_tso = torch.zeros_like(hl)
    for h in (0, 1):
        a, n = inside(h, t0, p.twin)
        n = torch.where(is_fwd == (h == 0), n, 0)
        n_tso += n
        spans[h].append((a, n))
    win_cols += n_used + n_tso
    levels = (meta[eg.ROW_AD_RUN] + 1).clamp(max=p.m_adc)
    run_ops = (2 * levels).clamp(max=min(EDGE_RUN_BITSLICE_OPS,
                                         3 * p.m_adc))
    w5 = torch.where(is_fwd[:, None],
                     gather_window(head, hl, t0, p.twin),
                     gather_window(tail, torch.full_like(hl, E),
                                   E - p.twin - t0, p.twin, rc=True))
    tso_best, _ = scan.match_run_stats(w5, p.tso_codes, p.m_tso)
    tl = (tso_best.long() + 1).clamp(max=p.c1)
    npairs = len(scan.bail_pairs(p.c1, p.c2))
    words = sum(((c + 31) // 32).sum() for c in scan_cols)
    ops = (int(words) * EDGE_WORD_OPS + int(win_cols.sum()) * MYERS_OPS
           + int((n_used * run_ops).sum())
           + int((n_tso * (2 * tl + EDGE_PAIR_OPS * npairs)).sum()))
    # bytes: the union of the columns each half's scan and windows read
    cover = 0
    for sp in spans:
        marks = torch.zeros((B, E + 1), dtype=torch.int32, device=dev)
        for a, n in sp:
            live = n > 0
            a0 = torch.where(live, a.clamp(0, E), 0)
            marks.scatter_add_(1, a0[:, None], live.int()[:, None])
            marks.scatter_add_(1, torch.where(live, (a + n).clamp(0, E),
                                              0)[:, None],
                               -live.int()[:, None])
        cover += int((marks.cumsum(1)[:, :-1] > 0).sum())
    n_bytes = cover + 4 * B + 4 * B * (eg.ROW_BC0 + p.bw)
    return {"operations": ops, "bytes": n_bytes,
            "scan_columns": int(sum(c.sum() for c in scan_cols)),
            "scan_words": int(words),
            "window_columns": int(win_cols.sum()),
            "adapter_columns": ad_cols, "used_columns": int(n_used.sum()),
            "tso_columns": int(n_tso.sum())}


def host_calls(dev) -> dict:
    """One call of each timed wrapper on a minimal input: one window of 90
    columns for `myers_win1`, one tile for `tile_scan`, one read for
    `edge_scan2` with the 3p and with the 5p parameters. Each is a
    functools.partial of the wrapper."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import editdist
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
    from sicelore_tpu_torch.utils import dna
    from sicelore_tpu_torch.utils.config import PipelineConfig
    peq = editdist.build_peq(np.arange(16, dtype=np.int8)[None, :] % 4)
    w = torch.zeros((1, 90), dtype=torch.int8, device=dev)
    rows = torch.from_numpy(tile_edge_rows(2)[1:]).to(dev)
    read = torch.full((1, 2 * eg.E), dna.PAD, dtype=torch.int8, device=dev)
    rlen = torch.zeros(1, dtype=torch.int32, device=dev)
    return {"win1": functools.partial(editdist.myers_win1, w, peq, 16),
            "tilescan": functools.partial(
                ts.tile_scan, rows, ts.tile_params(PipelineConfig())),
            **{key: functools.partial(edge_scan2, read, rlen, eg.edge_params(
                PipelineConfig(chemistry=chem)))
               for key, chem in (("edgescan", "3p"), ("edgescan_5p", "5p"))}}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds of one call of fn: `calls` calls back to back on
    the host clock, no sync between them (the launches queue up); the
    least of three rounds. What the wrapper's Python, its checks, the
    allocation of its output and the launch cost the caller."""
    import torch
    best = None
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
        best = us if best is None else min(best, us)
    return best


def wrapper_host_us(dev) -> dict:
    """host_us of each of host_calls(dev)."""
    return {name: host_us(fn) for name, fn in host_calls(dev).items()}


def umi_groups(seed=SEED + 900) -> dict:
    """The UMI groups of the pairwise kernel phase: {name: [UMI bytes]}.
    "g288": UMI_GROUP (256 of 12 nt, 32 of 16 nt), the timing group;
    "mixed": 160 UMIs of 10-14 nt, some with N, some equal but for an N,
    an empty UMI and UMIs of 33 nt (rows the host fills); "g3000": 3,000
    UMIs of 10-14 nt (a group at the single-link threshold); "g8192":
    UMI_BIG UMIs of 12 nt, UMI_BIG_INDEL of them with a base deleted or
    inserted (a group clustered single-link); "bytes256": 10-16 nt over
    ACGT, acgt, N and n, with UMIs that hold every byte value 0..255."""
    import numpy as np

    from sicelore_tpu_torch.utils import dna
    rng = np.random.default_rng(seed)

    def rand(n, lo, hi):
        return [dna.decode(rng.integers(0, 4, int(rng.integers(lo, hi + 1))))
                .encode() for _ in range(n)]

    mixed = rand(160, 10, 14)
    mixed += [u[:4] + b"N" + u[5:] for u in mixed[:12]]
    mixed += [b"", b"ACGTN" * 6 + b"ACG", b"ACGT" * 8 + b"G", b"NNNNNNNNNN"]
    groups = {"g288": [u for m, n in UMI_GROUP for u in rand(n, m, m)],
              "mixed": list(dict.fromkeys(mixed)),
              "g3000": rand(3_000, 10, 14)}
    big = []
    for u in rand(UMI_BIG, 12, 12):
        r, p = rng.random(), int(rng.integers(0, 12))
        if r < UMI_BIG_INDEL / 2:
            u = u[:p] + u[p + 1:]
        elif r < UMI_BIG_INDEL:
            u = u[:p] + b"ACGT"[int(rng.integers(0, 4)):][:1] + u[p:]
        big.append(u)
    groups["g8192"] = big
    alpha = list(b"ACGTACGTacgtNn")
    odd = [bytes(rng.choice(alpha, int(rng.integers(10, 17))).tolist())
           for _ in range(120)]
    allb = rng.permutation(256).astype(np.uint8).tobytes()
    odd += [allb[i:i + 16] for i in range(0, 256, 16)]
    odd += [b"AC" + allb[i:i + 9] + b"GT" for i in range(0, 256, 37)]
    groups["bytes256"] = list(dict.fromkeys(odd))
    return groups


def pairwise_work(lens) -> tuple[int, int]:
    """(operations, bytes) of one group's matrix from its UMI lengths:
    every pair of a pattern row of 1..32 nt and a text is len(text) global
    Myers columns (PAIRWISE_COLUMN_OPS each) and its distance
    (PAIRWISE_PAIR_OPS); bytes: the raw bytes and the K + 1 int32 offsets
    read once, the [K, K] int32 matrix written once."""
    import numpy as np
    ml = np.asarray(lens)
    K = len(ml)
    rows = int(((ml >= 1) & (ml <= 32)).sum())
    return (rows * (int(ml.sum()) * PAIRWISE_COLUMN_OPS
                    + K * PAIRWISE_PAIR_OPS),
            int(ml.sum()) + 4 * (K + 1) + 4 * K * K)


def group_call_split(umis, dev, calls) -> dict:
    """Host us of each step of one `umicluster._pairwise_ed_device` call
    on the card, a sync after each (the median of `calls` calls): host
    preparation (the join, the offsets, the one buffer), upload, launch
    and kernel (the wrapper's checks included), download (`to_host`:
    through pinned memory, in runs of rows above its PINNED_BYTES), host
    rows."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.core import umicluster
    from sicelore_tpu_torch.ops import editdist
    K = len(umis)
    steps = {k: [] for k in ("host_prep", "upload", "launch_kernel",
                             "download", "host_rows")}
    for _ in range(calls + 1):
        t = [time.perf_counter()]
        buf = editdist.group_buffer(umis)
        t.append(time.perf_counter())
        dbuf = torch.from_numpy(buf).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        d = editdist.myers_global_group(
            *editdist.group_views(dbuf, K, int(buf[K])), buf[:K + 1])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        h = umicluster.to_host(d)
        t.append(time.perf_counter())
        umicluster.host_rows(h, umis, np.diff(buf[:K + 1]))
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t, t[1:]):
            steps[k].append((b - a) * 1e6)
        del d, dbuf, h
    return {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in steps.items()}


def pairwise_phase(dev, int32_hz) -> dict:
    """csrc/pairwise.cu against its plain version on the card, element for
    element, on the umi_groups, each with variants of fresh content (one
    base of each UMI replaced); times of the 288-, 3,000- and 8,192-UMI
    groups; the host us of one whole group call
    (`umicluster._pairwise_ed_device`: the group's buffer, one upload, one
    launch, one download, the host rows) and its split beside the
    kernel's device_ms; the wrapper's host us and checks. Returns {result
    key: entry}."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.core import umicluster
    from sicelore_tpu_torch.ops import editdist
    rng = np.random.default_rng(SEED + 950)

    def variant(umis):
        out = []
        for u in umis:
            if u:
                c = int(rng.integers(0, len(u)))
                u = u[:c] + b"ACGT"[int(rng.integers(0, 4)):][:1] + u[c + 1:]
            out.append(u)
        return editdist.group_inputs(out, dev)

    def kern(a):
        return editdist.myers_global_group(*a)

    res = {}
    for name, umis in umi_groups().items():
        args = editdist.group_inputs(umis, dev)
        vars_ = [args] + [variant(umis) for _ in range(TIMED_CALLS)]
        key = f"pairwise_{name}"
        res[key] = compare(key, kern,
                           lambda a: editdist.myers_global_group_plain(*a),
                           vars_)
        ml = np.fromiter(map(len, umis), np.int32, len(umis))
        ops, nb = pairwise_work(ml)
        res[key].update(bound(nb, ops, int32_hz))
        res[key].update({"umis": len(umis), "raw_bytes": int(ml.sum()),
                         "host_rows": int(((ml == 0) | (ml > 32)).sum()),
                         "lengths": sorted(set(ml.tolist()))})
        if name in GROUP_CALLS:
            res[key]["device_ms"] = device_ms(kern, vars_[1:])
            res[key]["burst_ms"] = burst_ms(kern, vars_[1:])
        # the whole group call against the CPU's (host myers_ed rows
        # included); the 8,192 group (no host row) against the plain matrix
        d = umicluster._pairwise_ed_device(umis, dev)
        if name == "g8192":
            want = editdist.myers_global_group_plain(*args).cpu().numpy()
        else:
            want = umicluster._pairwise_ed_device(umis, "cpu")
        res[key]["mismatches"] += int((d != want).sum())
        if name == "mixed":
            hi = [i for i, u in enumerate(umis) if not 1 <= len(u) <= 32]
            res[key]["mismatches"] += sum(
                int(d[i, j] != umicluster.myers_ed(umis[i], umis[j]))
                for i in hi for j in range(len(umis)))
        del vars_, d, want
        if name in GROUP_CALLS:
            res[key]["group_call_us"] = host_us(
                lambda: umicluster._pairwise_ed_device(umis, dev),
                GROUP_CALLS[name])
            res[key]["group_call_split_us"] = group_call_split(
                umis, dev, GROUP_CALLS[name])
        torch.cuda.empty_cache()
    g = umi_groups()["g288"]
    args = editdist.group_inputs(g, dev)
    res["pairwise_g288"]["wrapper_host_us"] = host_us(lambda: kern(args))
    # the wrapper refuses what the kernel does not take: wrong dtypes, two
    # devices, no host offsets, offsets that fall or do not end at S, the
    # same bytes one past a 16-byte boundary
    raw, offs, ho = args
    falls = ho.copy()
    falls[3] = falls[5]
    shifted = editdist.group_inputs([b"G" + g[0]] + g[1:], dev)[0][1:]
    refused = 0
    for bad in ((raw.to(torch.int8), offs, ho), (raw, offs.long(), ho),
                (raw, offs.cpu(), ho), (raw, offs), (raw, offs, falls),
                (raw[:-1], offs, ho), (shifted, offs, ho)):
        try:
            editdist.myers_global_group(*bad)
        except ValueError:
            refused += 1
    res["pairwise_g288"]["refused"] = refused
    res["pairwise_g288"]["mismatches"] += 7 - refused
    return res


def encode_edge_reads(rng):
    """Reads the read encoding could get wrong: lengths 0, 1, under E, E -
    1, E, E + 1, between E and 2E, 2E - 1, 2E, 2E + 1 and far past 2E, each
    with a quality string of its length, one shorter (by 1, by E, empty) and
    one longer (by 1, by E); sequences over every byte value (NUL inside a
    read, lowercase, N) or over ACGTacgtN and NUL; qualities over every
    byte value (below '!', and above 160, where qv2 wraps); reads holding
    every byte value at both ends. Returns (seqs, quals)."""
    import numpy as np

    from sicelore_tpu_torch.ops.edgescan import E
    pool = np.frombuffer(b"ACGTacgtN\x00", np.uint8)
    seqs, quals = [], []
    for i, L in enumerate((0, 1, 7, E - 1, E, E + 1, 450, 2 * E - 1, 2 * E,
                           2 * E + 1, 3 * E + 5, ENCODE_LONG)):
        for j, dq in enumerate((0, -1, 1, -E, E, -L)):
            s = rng.integers(0, 256, L) if (i + j) % 2 else \
                rng.choice(pool, L)
            seqs.append(s.astype(np.uint8).tobytes())
            quals.append(rng.integers(0, 256, max(L + dq, 0))
                         .astype(np.uint8).tobytes())
    allb = rng.permutation(256).astype(np.uint8).tobytes()
    for s, q in ((allb, allb[::-1]), (allb * 3, allb * 3),
                 (b"ACGT" * 100 + allb, allb + b"I" * 400)):
        seqs.append(s)
        quals.append(q)
    return seqs, quals


def encode_shape_reads(rng):
    """Reads the kernel's widened spans and its stage could get wrong:
    lengths 0-17, E - 9 .. E + 9, 2E - 9 .. 2E + 9 and 3E - 9 .. 3E + 9 in
    a row (every span start and end at every offset in a 16-byte word);
    L = 0 beside Lq = 0 and beside a full quality string, and the reverse;
    L > 2E with Lq <= 2E and the reverse; qualities over every byte value.
    Returns (seqs, quals)."""
    import numpy as np

    from sicelore_tpu_torch.ops.edgescan import E
    pool = np.frombuffer(b"ACGTacgtN\x00", np.uint8)
    lens = [*range(18)]
    for m in (E, 2 * E, 3 * E):
        lens += range(m - 9, m + 10)
    pairs = [(L, L) for L in lens] + [
        (0, 0), (0, 2 * E + 5), (0, 40), (2 * E + 5, 0), (40, 0),
        (2 * E + 40, 2 * E), (2 * E + 1, E - 3), (3 * E, 17),
        (2 * E, 2 * E + 40), (E - 3, 2 * E + 1), (17, 3 * E)]
    seqs, quals = [], []
    for i, (L, Lq) in enumerate(pairs):
        s = rng.integers(0, 256, L) if i % 3 == 0 else rng.choice(pool, L)
        seqs.append(s.astype(np.uint8).tobytes())
        quals.append(rng.integers(0, 256, Lq).astype(np.uint8).tobytes())
    return seqs, quals


def encode_inputs_at(seqs, quals, dev, at_s: int, at_q: int):
    """The chunk's inputs on `dev` with seq and qual as views that start
    at_s and at_q bytes past a 16-byte boundary of a larger buffer (the
    bytes around them random): the kernel must read them wherever they
    start, and its widened spans touch the views' first and last bytes."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import encode_cuda as enc
    chunk = enc.join(seqs, quals)
    g = torch.Generator().manual_seed(at_s * 16 + at_q)
    views = []
    for buf, at in ((chunk.seq, at_s), (chunk.qual, at_q)):
        big = torch.randint(0, 256, (at + len(buf) + 32,), generator=g,
                            dtype=torch.uint8).to(dev)
        big[at:at + len(buf)] = torch.from_numpy(np.array(buf)).to(dev)
        views.append(big[at:at + len(buf)])
    return enc.EncodeInputs(views[0], torch.from_numpy(chunk.soffs).to(dev),
                            views[1], torch.from_numpy(chunk.qoffs).to(dev),
                            chunk.soffs, chunk.qoffs)


def encode_bytes(inp, two_half: bool) -> int:
    """The bytes an encode of these inputs must move (BOUNDS, encode)."""
    import numpy as np

    from sicelore_tpu_torch.ops.edgescan import E
    L, Lq = np.diff(inp.host_soffs), np.diff(inp.host_qoffs)
    B = len(L)
    return int(np.minimum(L, 2 * E).sum() + np.minimum(Lq, 2 * E).sum()
               + 2 * 8 * (B + 1) + B * 2 * 2 * E + (4 * B if two_half else 0))


def encode_variants(inp, g, n):
    """n copies of the inputs with fresh content: about one byte in 64 of
    the sequences and of the qualities replaced by a random byte (the
    offsets as they are)."""
    import torch
    out = []
    for _ in range(n):
        v = {}
        for k in ("seq", "qual"):
            t = getattr(inp, k).clone()
            m = torch.rand(t.shape, device=t.device, generator=g) < 1 / 64
            t[m] = torch.randint(0, 256, t.shape, device=t.device,
                                 generator=g, dtype=torch.uint8)[m]
            v[k] = t
        out.append(inp._replace(**v))
    return out


def encode_call(seqs, quals, dev):
    """One chunk's encode as the v2 passes run it (one shard): the join,
    the staging, the upload, the kernel, and qv2 and qsum down; returns
    them on the host."""
    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import encode_cuda as enc
    inp = enc.Staged(enc.join(seqs, quals), [(0, len(seqs))],
                    "cuda").upload(dev, 0, len(seqs))
    _, qv2, qsum = enc.encode_two_half_dev(*inp)
    hs = [readscan._to_host_async(t) for t in (qv2, qsum)]
    return [readscan._host(h) for h in hs]


def encode_call_split(seqs, quals, dev, calls) -> dict:
    """Host us of each step of `encode_call`, a sync after each (the median
    of `calls` calls): join, stage (into the pinned buffer), upload, kernel
    (the wrapper's checks included), download (qv2 and qsum); beside
    `whole`, the median us of `encode_call` with no sync between steps,
    and `numpy_encode_two_half`, the median us of the numpy encoder on the
    same reads (three calls)."""
    import torch

    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import encode_cuda as enc
    B = len(seqs)
    steps = {k: [] for k in ("join", "stage", "upload", "kernel",
                             "download")}
    whole, numpy_us = [], []
    for _ in range(calls + 1):
        t = [time.perf_counter()]
        ch = enc.join(seqs, quals)
        t.append(time.perf_counter())
        st = enc.Staged(ch, [(0, B)], "cuda")
        t.append(time.perf_counter())
        inp = st.upload(dev, 0, B)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        _, qv2, qsum = enc.encode_two_half_dev(*inp)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for h in [readscan._to_host_async(x) for x in (qv2, qsum)]:
            readscan._host(h)
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t, t[1:]):
            steps[k].append((b - a) * 1e6)
        t0 = time.perf_counter()
        encode_call(seqs, quals, dev)
        whole.append((time.perf_counter() - t0) * 1e6)
    for _ in range(3):
        t0 = time.perf_counter()
        eg.encode_two_half(seqs, quals)
        numpy_us.append((time.perf_counter() - t0) * 1e6)
    med = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    return {**{k: med(v[1:]) for k, v in steps.items()},
            "whole": med(whole[1:]), "numpy_encode_two_half": med(numpy_us)}


def encode_layout_cases(dev, chunk) -> dict:
    """Mismatches of both encode entries against their plain versions on
    what the kernel's layout could get wrong: encode_shape_reads with seq
    and qual starting at every byte offset 0-15 past a 16-byte boundary
    (views into a larger buffer), and the first B reads of `chunk`
    ((seqs, quals)) for B of 1, 2, one less, as many as and one more than
    the grid's warps, and several times them. {case: mismatches}."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import encode_cuda as enc
    out = {}
    seqs, quals = encode_shape_reads(np.random.default_rng(SEED + 1300))
    want = {e: getattr(enc, f"encode_{e}_plain")(
        *enc.chunk_inputs(seqs, quals, "cpu"))
        for e in ("two_half", "composite")}
    for at in range(16):
        inp = encode_inputs_at(seqs, quals, dev, at, (5 * at + 3) % 16)
        for e, w in want.items():
            got = getattr(enc, f"encode_{e}_dev")(*inp)
            out[f"{e}_at{at}"] = sum(int((g.cpu() != x).sum())
                                     for g, x in zip(got, w))
    gw = enc.grid_warps(dev)
    for B in (1, 2, gw - 1, gw, gw + 1, 3 * gw + 5):
        inp = enc.chunk_inputs(chunk[0][:B], chunk[1][:B], dev)
        for e in ("two_half", "composite"):
            got = getattr(enc, f"encode_{e}_dev")(*inp)
            w = getattr(enc, f"encode_{e}_plain")(*inp)
            out[f"{e}_b{B}"] = sum(int((g != x).sum()) for g, x in
                                   zip(got, w)) + int(len(got[0]) != B)
    torch.cuda.synchronize()
    return out


def encode_kernel_usage() -> dict:
    """csrc/encode.cu's two kernels as compiled: registers and spills
    (`nvcc -Xptxas -v`), shared memory and the SASS of the read loop
    (`utils/kernel_report`: its static instructions, the wait and the
    staging inside, and that over the 2E columns a warp's trip maps):
    {"two_half" | "composite": {...}}."""
    from sicelore_tpu_torch.ops import _build
    from sicelore_tpu_torch.ops.edgescan import E
    from sicelore_tpu_torch.utils import kernel_report as kr
    lib = _build.build_all()["encode"]
    sass = subprocess.run([kr._tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    res, loops, ptx = kr.resources(lib), kr.hottest_loops(sass), \
        kr.ptxas_usage("encode")
    names = kr._demangle(sorted(set(res) | set(loops) | set(ptx)))
    out = {}
    for k, name in names.items():
        m = re.search(r"encode_kernel<(?:\(bool\))?(1|0|true|false)>", name)
        if m is None:
            continue
        entry = "two_half" if m.group(1) in ("1", "true") else "composite"
        lp = loops.get(k, {})
        out[entry] = {
            "registers": ptx.get(k, {}).get("registers",
                                            res.get(k, {}).get("registers")),
            "spill_stores": ptx.get(k, {}).get("spill_stores"),
            "spill_loads": ptx.get(k, {}).get("spill_loads"),
            "static_shared": res.get(k, {}).get("shared"),
            "sass_read_loop": lp.get("outer_instructions"),
            "sass_a_column": lp.get("outer_instructions", 0) / (2 * E)}
    if set(out) != {"two_half", "composite"}:
        raise SystemExit(f"encode_kernel_usage: no two encode kernels in "
                         f"{sorted(names.values())}")
    smem = _build.load("encode").encode_shared_bytes()
    for u in out.values():
        u["dynamic_shared_a_block"] = smem
    return out


def encode_phase(dev, chunks, int32_hz) -> dict:
    """csrc/encode.cu's two entries against their plain versions on the
    card, byte for byte: on each chunk of `chunks` ({tag: (seqs, quals)},
    32,768 reads each) with fresh content a call, its device_ms, burst_ms
    and bound, and the host us of a whole chunk encode and its split beside
    the numpy encoder's (two-half entry); on encode_edge_reads in one launch
    and in spans of 1, 36 and the rest (rebased offsets), both also
    against the numpy oracles and through the pageable copy of a chunk over
    the staging bound; the wrappers' refusals. Returns {result key:
    entry}."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import encode_cuda as enc
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1100)
    res = {}
    usage = encode_kernel_usage()
    for tag, (seqs, quals) in chunks.items():
        inp = enc.chunk_inputs(seqs, quals, dev)
        vars_ = [inp] + encode_variants(inp, g, TIMED_CALLS)
        for entry in ("two_half", "composite"):
            kern = getattr(enc, f"encode_{entry}_dev")
            plain = getattr(enc, f"encode_{entry}_plain")
            key = f"encode_{entry}_{tag}"
            res[key] = compare(key, lambda a: kern(*a), lambda a: plain(*a),
                               vars_)
            res[key].update(bound(encode_bytes(inp, entry == "two_half"), 0,
                                  int32_hz))
            res[key].update({
                "reads": len(seqs),
                "device_ms": device_ms(lambda a: kern(*a), vars_[1:]),
                "burst_ms": burst_ms(lambda a: kern(*a), vars_[1:])})
            res[key]["share"] = res[key]["bound_ms"] / res[key]["device_ms"]
        for entry, u in usage.items():
            res[f"encode_{entry}_{tag}"].update(u)
        two = res[f"encode_two_half_{tag}"]
        two["wrapper_host_us"] = host_us(
            lambda: enc.encode_two_half_dev(*inp), 200)
        two["chunk_call_split_us"] = encode_call_split(seqs, quals, dev,
                                                       ENCODE_CALLS)
        del vars_, inp
        torch.cuda.empty_cache()
    seqs, quals = encode_edge_reads(np.random.default_rng(SEED + 1200))
    n = len(seqs)
    spans = [(0, 1), (1, 37), (37, n)]
    oracle = {"two_half": eg.encode_two_half(seqs, quals),
              "composite": readscan.encode_composite(seqs, quals)}
    cases = {}
    staging = enc.STAGING_BYTES
    for route, limit in (("pinned", staging), ("pageable", 1024)):
        enc.STAGING_BYTES = limit
        try:
            whole = enc.chunk_inputs(seqs, quals, dev)
            st = enc.Staged(enc.join(seqs, quals), spans, "cuda")
            parts = [st.upload(dev, a, b) for a, b in spans]
        finally:
            enc.STAGING_BYTES = staging
        cpu = enc.chunk_inputs(seqs, quals, "cpu")
        for entry in ("two_half", "composite"):
            kern = getattr(enc, f"encode_{entry}_dev")
            want = getattr(enc, f"encode_{entry}_plain")(*cpu)
            got = [x.cpu() for x in kern(*whole)]
            cut = [torch.cat(x) for x in zip(*(kern(*p) for p in parts))]
            want_np = [oracle[entry][0], oracle[entry][1]] + (
                [oracle[entry][3]] if entry == "two_half" else [])
            cases[f"{entry}_{route}"] = sum(
                int((w != x.cpu()).sum()) + int((w.numpy() != o).sum())
                + int((w != c.cpu()).sum())
                for w, x, c, o in zip(want, got, cut, want_np))
    cases.update(encode_layout_cases(dev, chunks["3p"]))
    res["encode_edge_cases"] = {"mismatches": sum(cases.values()),
                                "cases": cases, "reads": n,
                                "spans": spans}
    # the refusals: wrong dtypes, offsets without their host copy, a fall,
    # a size mismatch, soffs and qoffs of other lengths, a strided offsets
    inp = enc.chunk_inputs(seqs, quals, dev)
    falls = inp.host_soffs.copy()
    falls[2] = falls[-1] + 1
    bad = (inp._replace(seq=inp.seq.view(torch.int8)),
           inp._replace(soffs=inp.soffs.int()), inp[:4],
           inp._replace(host_soffs=falls), inp._replace(seq=inp.seq[:-1]),
           inp._replace(qoffs=inp.qoffs[:-1], host_qoffs=inp.host_qoffs[:-1]),
           inp._replace(soffs=torch.stack([inp.soffs, inp.soffs], 1)[:, 0]))
    refused = 0
    for b in bad:
        for kern in (enc.encode_two_half_dev, enc.encode_composite_dev):
            try:
                kern(*b)
            except ValueError:
                refused += 1
    res["encode_edge_cases"].update({"refused": refused,
                                     "refusals": 2 * len(bad)})
    res["encode_edge_cases"]["mismatches"] += 2 * len(bad) - refused
    return res


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def levenshtein(a: bytes, b: bytes) -> int:
    import numpy as np
    x, y = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    idx = np.arange(len(y) + 1)
    prev = idx.copy()
    for i, ch in enumerate(x, 1):
        cur = np.concatenate([[i], np.minimum(prev[1:] + 1,
                                              prev[:-1] + (y != ch))])
        prev = np.minimum.accumulate(cur - idx) + idx   # moves along y
    return int(prev[-1])


def band_pairs(rng, Lc, W, n_pairs, lo, hi, dev):
    """`band_align` arguments on the card for one bucket shape: molecules
    of 5 reads (4 pairs) of a random truth of lo..hi bases at 3% error."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.utils import synth
    mols = []
    for _ in range(n_pairs // 4):
        truth = synth.random_seq(rng, int(rng.integers(lo, hi))).encode()
        mols.append([synth.mutate_np(rng, truth, 0.03) for _ in range(5)])
    center, clens, reads, rlens, mids = synth.pair_arrays(mols, Lc, W)
    first = np.searchsorted(mids, np.arange(len(mols)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                 (reads, rlens, mids, center[first], clens[first]))


# Small shapes that the sweep's slices make possible to get wrong:
# name: (B, N, nvalid, W, m, slices, duplicate barcodes (dst, src))
SWEEP_EDGE_CASES = {
    "ragged_last_slice": (300, 1001, 1001, 22, 16, 7, ((1000, 3), (600, 3))),
    "nvalid_inside_slice": (300, 1024, 700, 22, 16, 4, ((650, 10),)),
    "nvalid_one": (300, 1024, 1, 22, 16, 4, ()),
    "nvalid_zero": (64, 256, 0, 22, 16, 4, ()),
    "same_barcode_in_two_slices": (300, 1024, 1024, 22, 16, 8,
                                   ((900, 5), (300, 5), (513, 512))),
    "fewer_barcodes_than_slices": (300, 5, 5, 22, 16, 64, ((4, 0),)),
    "one_read": (1, 777, 777, 22, 16, 5, ()),
    "b37": (37, 777, 770, 22, 16, 5, ((700, 1),)),
    "narrow_window": (200, 640, 640, 17, 16, 3, ((639, 0),)),
    "w16": (200, 640, 640, 16, 12, 3, ()),
    "m31_w32": (200, 640, 640, 32, 31, 6, ((400, 2),)),
    "slices_chosen_by_the_wrapper": (4096, 2048, 2048, 22, 16, None,
                                     ((2000, 9),)),
    "one_slice": (600, 300, 300, 22, 16, 1, ((299, 0),)),
}


def sweep_edge_case(name, dev):
    """The inputs of one SWEEP_EDGE_CASES entry on `dev`: windows [W, B]
    uint8 with planted barcodes (one substitution in every fourth, N, PAD
    tails, an all-PAD read) and the Peq [4, N] of N random barcodes with
    the case's duplicates. Returns (wins_tm, peq, nvalid, m, slices,
    whether the valid list holds a duplicate, i.e. ties must show)."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import bcsearch, editdist
    B, N, nvalid, W, m, slices, dup = SWEEP_EDGE_CASES[name]
    rng = np.random.default_rng(SEED + len(name))
    pats = rng.integers(0, 4, size=(N, m)).astype(np.int8)
    for dst, src in dup:
        pats[dst] = pats[src]
    wins = rng.integers(0, 4, size=(B, W)).astype(np.uint8)
    for i in range(B):
        j = dup[i % len(dup)][1] if dup and i % 3 == 0 else \
            int(rng.integers(0, N))
        off = int(rng.integers(0, W - m + 1))
        wins[i, off:off + m] = pats[j]
        if i % 4 == 1:
            wins[i, off + m // 2] = (wins[i, off + m // 2] + 1) % 4
    wins[::5, W // 3] = 4
    wins[::7, -(W // 5 + 1):] = 5
    wins[B - 1] = 5
    return (torch.from_numpy(np.ascontiguousarray(wins.T)).to(dev),
            bcsearch.peq_device(editdist.build_peq(pats), dev), nvalid, m,
            slices, bool(dup) and nvalid > max(d for d, _ in dup))


def merge_edge_partials(dev):
    """Partials [6, 4, 1000] int32 for the merge kernel alone: ties between
    slices, a slice of masked barcodes only, (BIG, _, BIG, -1), in first,
    middle and last place, and reads whose every slice is masked."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import bcsearch
    rng = np.random.default_rng(SEED + 77)
    S, B = 6, 1000
    parts = np.empty((S, 4, B), dtype=np.int32)
    parts[:, 0] = rng.integers(0, 4, (S, B))
    parts[:, 1] = np.arange(S)[:, None] * 100 + rng.integers(0, 100, (S, B))
    parts[:, 2] = parts[:, 0] + rng.integers(0, 3, (S, B))
    parts[:, 3] = rng.integers(-1, 22, (S, B))
    for sl, cols in ((0, slice(0, 300)), (3, slice(200, 500)),
                     (5, slice(400, 700)), (slice(None), slice(900, B))):
        parts[sl, 0, cols] = parts[sl, 2, cols] = bcsearch.BIG
        parts[sl, 3, cols] = -1
    parts[0, 1, 900:] = 0
    return torch.from_numpy(parts).to(dev)


def sweep_edge_cases(dev) -> dict:
    """The sweep kernel against its plain version on SWEEP_EDGE_CASES (both
    `track_pos` values), and the merge kernel alone against
    `merge_sweep_partials_plain`: {case: mismatches}."""
    from sicelore_tpu_torch.ops import bcsearch
    out = {}
    for name in SWEEP_EDGE_CASES:
        wt, peq, nvalid, m, slices, ties = sweep_edge_case(name, dev)
        bad = 0
        for track in (True, False):
            k = bcsearch._bc_sweep_sliced(wt, peq, nvalid, m, track, slices)
            pl = bcsearch.bc_sweep_plain(wt, peq, nvalid, m, track)
            bad += int((k != pl).sum())
            if ties and not int((pl[0] == pl[2]).sum()):
                raise SystemExit(f"sweep case {name}: no tie in the data")
        out[name] = bad
    parts = merge_edge_partials(dev)
    out["merge_kernel"] = int((bcsearch.merge_sweep_partials(parts)
                               != bcsearch.merge_sweep_partials_plain(parts)
                               ).sum())
    return out


TILE_EDGE_KINDS = ("random", "one_cassette_each", "three_runs_each",
                   "five_runs_each", "own_lo_and_own_hi_minus_1",
                   "tlen_minus_k_and_windows_off_both_ends", "all_pad",
                   "lane_boundaries_and_threshold", "n_inside_runs",
                   "guard_near_read_ends")


def tile_edge_rows(n: int, seed: int = SEED + 500):
    """n tile rows [n, 528] uint8 (build_tiles' layout) cycling through
    TILE_EDGE_KINDS: tiles with 0, 1, 3 and 5 polyA and polyT runs, full
    adapter cassettes (so the confirms pass) and bare runs, runs starting at
    own_lo, at own_hi - 1 and at tlen - k, confirm windows running off both
    tile ends, an all-PAD tile (tlen 0), runs across 32-column boundaries
    with exactly mc and mc - 1 A bases in a window, N inside runs, splits
    within 50 bases of the read's ends."""
    import numpy as np

    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.utils import dna
    from sicelore_tpu_torch.utils.config import PipelineConfig
    cfg = PipelineConfig()
    k = cfg.polyat.internal_pat_length
    mc = int(np.ceil(cfg.polyat.internal_fraction_at_in_polyat * k - 1e-9))
    adapter = dna.encode(cfg.adapter3p.sequence_complete.encode())
    comp = np.asarray(dna._COMP, np.int8)
    rng = np.random.default_rng(seed)
    TILE = readscan.TILE

    def t_cassette(s):      # adapter, BC, UMI, then a polyT run at s
        return (s - 50, np.concatenate([adapter, rng.integers(
            0, 4, 28).astype(np.int8), np.full(20, dna.T, np.int8)]))

    def a_cassette(s):      # a polyA run at s, then the reverse complement
        seg = t_cassette(0)[1]
        return s, comp[seg[::-1]]

    codes = np.full((n, TILE), dna.PAD, np.int8)
    meta = np.zeros((n, 5), np.int64)       # own_lo, own_hi, tlen, g0, rlen
    for i in range(n):
        kind = TILE_EDGE_KINDS[i % len(TILE_EDGE_KINDS)]
        tlen = int(rng.integers(600, TILE + 1))
        own_lo, own_hi = int(rng.integers(0, 120)), tlen - k + 1
        g0 = int(rng.integers(0, 4000))
        rlen = g0 + tlen + int(rng.integers(0, 3000))
        c = rng.integers(0, 4, TILE).astype(np.int8)
        plants = []
        if kind == "one_cassette_each":
            plants = [t_cassette(int(rng.integers(200, 400))),
                      a_cassette(int(rng.integers(420, tlen - 140)))]
        elif kind == "three_runs_each":
            for j in range(3):
                plants.append(t_cassette(200 + 60 * j) if j == 1 else
                              (200 + 60 * j, np.full(17, dna.T, np.int8)))
                plants.append((400 + 50 * j, np.full(16 + j, dna.A, np.int8)))
        elif kind == "five_runs_each":
            for j in range(5):
                plants.append((130 + 45 * j, np.full(15, dna.T, np.int8)))
                plants.append((360 + 45 * j, np.full(15, dna.A, np.int8)))
        elif kind == "own_lo_and_own_hi_minus_1":
            own_lo = int(rng.integers(100, 200))
            own_hi = int(rng.integers(own_lo + 200, tlen - 60))
            # the T run's first passing window is own_hi - 1 exactly
            plants = [(own_lo - 6, np.full(25, dna.A, np.int8)),
                      t_cassette(own_lo + 60),
                      (own_hi - 6, np.full(5 + k - mc, dna.C, np.int8)),
                      (own_hi - 1 + k - mc, np.full(18, dna.T, np.int8))]
        elif kind == "tlen_minus_k_and_windows_off_both_ends":
            end = np.full(k + 3, dna.C, np.int8)   # mc A at the very end
            end[-mc:] = dna.A
            plants = [(tlen - k - 3, end),
                      (tlen - 90, np.full(20, dna.A, np.int8)),
                      (int(rng.integers(20, 60)), np.full(20, dna.T, np.int8))]
            own_lo = 0
        elif kind == "all_pad":
            tlen, own_lo, own_hi = 0, 0, int(rng.integers(300, 900))
        elif kind == "lane_boundaries_and_threshold":
            ok_win = np.asarray([0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 3, 0, 0, 1, 0],
                                np.int8)            # 11 A of 15: passes
            bad_win = ok_win.copy()
            bad_win[0] = 1                          # 10 A of 15: fails
            plants = [(28, np.full(8, dna.C, np.int8)),   # edges at 32, 95
                      (32 + k - mc, np.full(15, dna.A, np.int8)),
                      (91, np.full(8, dna.C, np.int8)),
                      (95 + k - mc, np.full(15, dna.T, np.int8)),
                      (250, ok_win), (300, bad_win), (350, 3 - ok_win),
                      (480, np.full(40, dna.A, np.int8))]
            own_lo = 0
        elif kind == "n_inside_runs":
            run = np.full(22, dna.A, np.int8)
            run[[3, 9, 15]] = 4
            plants = [(220, run), t_cassette(400), (520, np.where(
                run == dna.A, dna.T, run).astype(np.int8))]
        elif kind == "guard_near_read_ends":
            g0 = 0
            rlen = tlen + int(rng.integers(0, 40))
            plants = [t_cassette(90), a_cassette(tlen - 200)]
        for s, seg in plants:
            lo, hi = max(s, 0), min(s + len(seg), TILE)
            c[lo:hi] = seg[lo - s:hi - s]
        c[tlen:] = dna.PAD
        codes[i] = c
        meta[i] = (own_lo, own_hi, tlen, g0, rlen)
    rows = np.zeros((n, TILE // 2 + 16), np.uint8)
    rows[:, :TILE // 2] = readscan.pack_nibbles_np(codes)
    mv = rows[:, TILE // 2:]
    for j, col in ((0, 0), (2, 1), (4, 2)):
        mv[:, j] = meta[:, col] & 0xFF
        mv[:, j + 1] = meta[:, col] >> 8
    mv[:, 8:12] = meta[:, 3].astype("<u4").view(np.uint8).reshape(-1, 4)
    mv[:, 12:16] = meta[:, 4].astype("<u4").view(np.uint8).reshape(-1, 4)
    return rows


# The window search's edge sets: (B, W, m, byte offset of the first row
# from a 16-byte boundary). Offsets 1..15 put a block's span start anywhere
# modulo 16 (W = 110 and 90 already move it from block to block); W = 200
# takes the kernel's rounds of 160 columns.
WIN1_EDGE_SHAPES = ((1, 1, 4, 3), (1, 90, 16, 0), (37, 110, 22, 5),
                    (129, 160, 22, 0), (129, 110, 10, 7), (129, 90, 16, 13),
                    (37, 1, 1, 15), (129, 160, 31, 9), (300, 200, 32, 1),
                    (1, 160, 22, 11))


def win1_edge_windows(B, W, m, off, seed=SEED + 600):
    """(windows [B, W] int8 numpy, pattern [m] int8) for one
    WIN1_EDGE_SHAPES entry: codes 0..5 with planted matches (one
    substituted base in every second plant), PAD tails and an all-PAD
    row; `off` is applied by the caller as the view's start in a larger
    buffer."""
    import numpy as np
    rng = np.random.default_rng(seed + 1000 * B + W + off)
    pat = rng.integers(0, 4, m).astype(np.int8)
    wins = rng.integers(0, 6, (B, W)).astype(np.int8)
    for i in range(0, B, 2):
        if W >= m:
            o = int(rng.integers(0, W - m + 1))
            wins[i, o:o + m] = pat
            if i % 4 == 2 and m > 2:
                wins[i, o + m // 2] = (wins[i, o + m // 2] + 1) % 4
    wins[1::7, -(W // 4 + 1):] = 5
    wins[B // 2] = 5
    return wins, pat


def unaligned_rows(a, off: int, dev):
    """`a` [B, W] as a contiguous tensor on `dev` whose data starts `off`
    bytes after a 16-byte boundary (a view into a larger buffer)."""
    import torch
    buf = torch.zeros(a.size + 64, dtype=torch.int8, device=dev)
    base = (-buf.data_ptr()) % 16 + off
    v = buf[base:base + a.size].view(a.shape)
    v.copy_(torch.from_numpy(a).to(dev))
    return v


def band_edge_pairs(rng, n_pairs, length, Lc, W, dev):
    """`band_align` arguments for n_pairs pairs (any count) with reads that
    run out of the band (infeasible), a long insertion answered by a long
    deletion (the path hugs the band's edge, where a pair may freeze),
    empty reads and one molecule whose center length is 0."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.utils import synth
    mols, n = [], 0
    while n < n_pairs + 6:
        truth = synth.random_seq(rng, int(rng.integers(length // 2, length)))
        depth = int(rng.integers(2, 7))
        reads = [synth.mutate(rng, truth, 0.05).encode()
                 for _ in range(depth)]
        kind = len(mols) % 5
        if kind == 1:
            reads[1] = truth[:len(truth) - W].encode()
        elif kind == 2:
            blk = synth.random_seq(rng, W // 2 + 6)
            reads[1] = (truth[:40] + blk + truth[40:90]
                        + truth[90 + len(blk):]).encode()
        elif kind == 3:
            reads[-1] = b""
        mols.append([truth.encode()] + reads)
        n += depth
    center, clens, reads, rlens, mids = synth.pair_arrays(mols, Lc, W)
    first = np.searchsorted(mids, np.arange(len(mols)))
    clens_mol = clens[first].copy()
    clens_mol[min(2, len(mols) - 1)] = 0
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                 (reads[:n_pairs], rlens[:n_pairs], mids[:n_pairs],
                  center[first], clens_mol))


def consensus_molecules(rng, n):
    """bench.py's consensus mix: 50% one read, 20% two, 30% 3-12 reads of a
    400-900 nt truth at 3% error; ~1% of the multi-read molecules carry an
    N; the last four are over 2,048 nt. Returns (molecules, truths)."""
    from sicelore_tpu_torch.utils import synth
    mols, truths = [], []
    for m in range(n):
        u = rng.random()
        depth = 1 if u < 0.5 else 2 if u < 0.7 else int(rng.integers(3, 13))
        length = int(rng.integers(400, 900))
        if m >= n - 4:
            depth, length = 3, int(rng.integers(2100, 2300))
        truth = synth.random_seq(rng, length).encode()
        reads = [synth.mutate_np(rng, truth, 0.03) for _ in range(depth)]
        if depth > 2 and rng.random() < 0.01:
            r = bytearray(reads[1])
            r[int(rng.integers(0, len(r)))] = 78
            reads[1] = bytes(r)
        mols.append(reads)
        truths.append(truth)
    return mols, truths


def write_bam(path, mols, rng, prefix):
    """The molecules as a tagged BAM; returns {"BC-U8": molecule index}."""
    from sicelore_tpu_torch.io.bam import BamHeader, BamWriter
    from sicelore_tpu_torch.utils import synth
    keys = {}
    hdr = BamHeader("@SQ\tSN:chr1\tLN:1000000\n", [("chr1", 1_000_000)])
    with BamWriter(path, hdr, level=1) as w:
        for rec in synth.tagged_records(mols, rng, prefix):
            keys[f"{rec.get_tag('BC')}-{rec.get_tag('U8')}"] = \
                int(rec.qname[len(prefix):].split("r")[0])
            w.write(rec)
    return keys


def read_fastq_records(path):
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return [(lines[i][1:].decode(), lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 1, 4)]


def timed_fn(secs, owner, attr, key, sync=False):
    """Replace owner.attr by a wrapper that adds its seconds to secs[key]
    (key() when key is callable; after a device sync when `sync`); returns
    the undo function."""
    import torch
    fn = getattr(owner, attr)

    def wrapper(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        k = key() if callable(key) else key
        secs[k] = secs.get(k, 0.0) + time.perf_counter() - t
        return out
    wrapper.launches = getattr(fn, "launches", 0)
    setattr(owner, attr, wrapper)
    return lambda: setattr(owner, attr, fn)


def consensus_split(bam, out_fastq) -> dict:
    """compute_consensus once more with the program's tracer on: seconds
    by span name (`utils/trace.py`; the engine's spans `consensus.route`,
    `.host`, `.pack`, `.upload`, `.device`, `.wait` and `.decode` are
    siblings, so they add up), the host engine's also by route
    (`consensus.host.<route>`), and the whole call's."""
    from sicelore_tpu_torch.pipeline import consensus
    from sicelore_tpu_torch.utils import trace
    trace.enable()
    try:
        consensus.compute_consensus(bam, out_fastq, device="cuda")
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    secs: dict[str, float] = {}
    for sp in snap["spans"]:
        keys = [sp["name"]]
        if sp["name"] == "consensus.host":
            keys.append(f"consensus.host.{sp['attrs']['route']}")
        for k in keys:
            secs[k] = secs.get(k, 0.0) + (sp["end"] - sp["start"]) / 1e9
    return {k: round(v, 3) for k, v in secs.items()}


def composed_split(codes, lens_d, ep) -> dict:
    """One call of the composed edge body with a sync-timed wrapper around
    each scan op: milliseconds by op, and of the whole call."""
    import torch

    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import scan
    from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
    secs: dict[str, float] = {}
    undo = [timed_fn(secs, scan, "polyat_find", "polyat_find", sync=True),
            timed_fn(secs, readscan, "gather_window", "gather_window",
                     sync=True),
            timed_fn(secs, scan, "adapter_search", "adapter_search",
                     sync=True),
            timed_fn(secs, scan, "match_run_stats", "match_run_stats",
                     sync=True),
            timed_fn(secs, scan, "run_bailout", "run_bailout", sync=True)]
    n = eg.edge_scan2_composed.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        eg.edge_scan2_composed(codes[:, :eg.E], codes[:, eg.E:], lens_d, ep)
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    secs["total"] = time.perf_counter() - t
    if eg.edge_scan2_composed.launches != n + 1:
        raise SystemExit("composed_split did not run the composed body")
    secs["rest"] = secs["total"] - sum(v for k, v in secs.items()
                                       if k != "total")
    return {k: round(v * 1e3, 3) for k, v in secs.items()}


def scanfastq_split(pipe, inputs, out_dir) -> dict:
    """pipe.run with a timer around each stage (device stages end in a
    synchronize, so nothing overlaps): seconds by stage. The read encoding
    in four: `encode_join` (the bytes joined, the offsets), `encode_stage`
    (into the pinned staging buffer), `encode_upload` (a shard's copy) and
    `encode_kernel` (both entries); `download` is every device->host copy
    of the scans (qv2, qsum and qv with the result rows). `v1_edge_scan`
    is the v1 composite edge scan (the model's `_edge_fn`), `qvs_v1` its
    host QVs; `other` is the fastq parse, the writers and what is left."""
    import torch

    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import bcsearch
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import encode_cuda as enc
    from sicelore_tpu_torch.pipeline import scanfastq as sf
    secs: dict[str, float] = {}
    pl = sf.ScanFastqPipeline
    undo = [
        timed_fn(secs, enc, "join", "encode_join"),
        timed_fn(secs, enc.Staged, "__init__", "encode_stage"),
        timed_fn(secs, enc.Staged, "upload", "encode_upload", sync=True),
        timed_fn(secs, enc, "encode_two_half_dev", "encode_kernel",
                 sync=True),
        timed_fn(secs, enc, "encode_composite_dev", "encode_kernel",
                 sync=True),
        timed_fn(secs, readscan, "_to_host_async", "download", sync=True),
        timed_fn(secs, readscan, "build_tiles", "build_tiles"),
        timed_fn(secs, readscan, "tile_feed", "tile_feed", sync=True),
        timed_fn(secs, readscan, "edge_scan2", "edge_scan", sync=True),
        timed_fn(secs, readscan, "tile_scan", "tile_scan", sync=True),
        timed_fn(secs, bcsearch, "bc_sweep", "bc_sweep", sync=True),
        timed_fn(secs, pipe.model, "_edge_fn", "v1_edge_scan", sync=True),
        timed_fn(secs, readscan, "compute_qvs_np", "qvs_v1"),
        timed_fn(secs, eg, "compute_qvs2_np", "qvs_v2"),
        timed_fn(secs, readscan, "finalize_rows_np", "finalize_rows"),
        timed_fn(secs, pl, "_pass1_apply", "pass1_count"),
        timed_fn(secs, pl, "build_used_list", "build_used_list"),
        timed_fn(secs, pl, "_split_parts_chunk", "split_parts"),
        timed_fn(secs, pl, "pass2_emit", "emit"),
        timed_fn(secs, pl, "_write_reports", "reports"),
    ]
    t = time.perf_counter()
    try:
        stats = pipe.run(inputs, out_dir)
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    secs["total"] = time.perf_counter() - t
    secs["other"] = secs["total"] - sum(
        v for k, v in secs.items() if k != "total")
    return {"stats": stats.to_json(),
            "seconds": {k: round(v, 3) for k, v in secs.items()}}


def device_ms(fn, variants):
    """Mean device milliseconds of fn(v) over the variants with no host time
    in it: a spin kernel (torch.cuda._sleep) holds the stream while the host
    queues an event, every call and a second event, so the two events
    bracket the calls' launches run back to back. The spin must outlast the
    host's queueing, which is checked on the host clock; it grows until it
    does. Every launch of a call counts (the sweep's merge kernel with its
    sweep). CUDA events only: torch.profiler traces on the card lost kernel
    records and once read a kernel at half its time."""
    import torch
    fn(variants[0])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = SPIN_CYCLES
    for _ in range(6):
        t = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        for v in variants:
            fn(v)
        ev[2].record()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms:
            return ev[1].elapsed_time(ev[2]) / len(variants)
        cycles *= 4
    raise SystemExit("device_ms: the spin kernel never outlasted the host's "
                     "queueing")


def burst_ms(fn, variants):
    """Mean ms of fn(v) over the variants launched back to back between two
    CUDA events: the wrappers' host time hides behind the kernels, so for a
    kernel longer than its wrapper's Python this is the kernel's time."""
    import torch
    fn(variants[0])
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for v in variants:
        fn(v)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / len(variants)


def write_subset(src, dst, n):
    """The first n reads of fastq file src as dst; returns the chunk."""
    from sicelore_tpu_torch.io import fastq
    head = next(fastq.read_fastq(src, n))
    dst.parent.mkdir(parents=True, exist_ok=True)
    with open(dst, "wb") as fh:
        for nm, sq, q in zip(head.names, head.seqs, head.quals):
            fh.write(b"@%s\n%s\n+\n%s\n" % (nm, sq, q))
    return head


def cuda_cpu_outputs(make_pipe, inputs, work, tag):
    """Run make_pipe(device) over inputs on `cuda` and on `cpu`; every
    output file but the HTML report must be byte-identical. Returns (number
    of files, the cuda pipeline, the cuda output directory, {device:
    {counter: launches > 0}} of each run, `path_counters`)."""
    blobs, pipes, launches = {}, {}, {}
    counters = path_counters()
    for d in ("cuda", "cpu"):
        out = work / f"{tag}_{d}"
        pipes[d] = make_pipe(d)
        before = {k: c.launches for k, c in counters.items()}
        pipes[d].run(inputs, out)
        launches[d] = {k: c.launches - before[k]
                       for k, c in counters.items()
                       if c.launches != before[k]}
        blobs[d] = {str(f.relative_to(out)): f.read_bytes()
                    for f in sorted(out.rglob("*")) if f.is_file()
                    and f.name != "ReadScanner.html"}
    diff = sorted(k for k in set(blobs["cuda"]) | set(blobs["cpu"])
                  if blobs["cuda"].get(k) != blobs["cpu"].get(k))
    if diff or not blobs["cuda"]:
        raise SystemExit(f"{tag}: cuda/cpu outputs differ: {diff}")
    return len(blobs["cuda"]), pipes["cuda"], work / f"{tag}_cuda", launches


def fused_split(launches) -> dict:
    """The tile scan launches of a cached run on one card split in two:
    `tilescan_fused`, one a tile feed launch (its rows), and
    `tilescan_residue`, the host tiles of the reads the feed does not
    cover (and of split rescans: none, they run the edge scan)."""
    fused = launches.get("tilefeed", 0)
    return {"tilescan_fused": fused,
            "tilescan_residue": launches.get("tilescan", 0) - fused}


def check_fused_parity(tag, launches) -> None:
    """A parity phase's cached runs: the `cuda` run took the fused tile
    route (the feed launched, no plain body), the `cpu` run the host tiles
    (no feed, plain or not), so equal bytes hold fused == host."""
    cu, cpu = launches["cuda"], launches["cpu"]
    if (cu.get("tilefeed", 0) < 1 or any(k.startswith("plain_") for k in cu)
            or "plain_tilefeed" in cpu or "tilefeed" in cpu
            or cpu.get("plain_tilescan", 0) < 1):
        raise SystemExit(f"{tag}: launches cuda {cu}, cpu {cpu}")


def bc_truth(passed_dir, cells):
    """(agreeing, checked) assigned barcodes of unsplit r<i>c<cell> reads
    against the generator's truth."""
    from sicelore_tpu_torch.io import fastq
    from sicelore_tpu_torch.pipeline import readname
    n_ok = n_tot = 0
    for f in sorted(passed_dir.iterdir()):
        for ch in fastq.read_fastq(f):
            for nm in ch.names:
                info = readname.parse_name(nm)
                if info is None:
                    raise SystemExit(f"unparsable passed name {nm!r}")
                o = info.orig_name
                if o.startswith("r") and "c" in o and "sp" not in o:
                    n_tot += 1
                    n_ok += info.bc == cells[int(o.split("c")[1])]
    return n_ok, n_tot


def chain_genome(rng, n_contigs, contig_len, n_genes, exon_len=(250, 700)):
    """A synthetic genome and its genes: contigs of random bases; genes of
    one exon (twice exon_len: 500-1,400 nt) or two (exon_len each around a
    300-2,000 nt intron with GT..AG at its ends, CT..AC on the minus
    strand), one a slot of contig_len * n_contigs / n_genes bases. Returns
    (contigs
    {name: bytes}, genes [(name, chrom, strand, [(start, end), ...])],
    0-based half-open exons)."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    per = n_genes // n_contigs
    slot = contig_len // per
    contigs, genes = {}, []
    for c in range(n_contigs):
        chrom = f"chr{c + 1}"
        seq = bytearray(acgt[rng.integers(0, 4, contig_len)].tobytes())
        for k in range(per):
            strand = "+" if rng.random() < 0.5 else "-"
            lo, hi = exon_len
            if rng.random() < 0.5:
                lens = [int(rng.integers(2 * lo, 2 * hi))]
                intron = 0
            else:
                lens = [int(rng.integers(lo, hi)), int(rng.integers(lo, hi))]
                intron = int(rng.integers(300, 2000))
            span = sum(lens) + intron
            s = k * slot + int(rng.integers(100, slot - span - 100))
            exons = [(s, s + lens[0])]
            if intron:
                i0, i1 = s + lens[0], s + lens[0] + intron
                exons.append((i1, i1 + lens[1]))
                don, acc = (b"GT", b"AG") if strand == "+" else (b"CT", b"AC")
                seq[i0:i0 + 2], seq[i1 - 2:i1] = don, acc
            genes.append((f"G{len(genes)}", chrom, strand, exons))
        contigs[chrom] = bytes(seq)
    return contigs, genes


def write_chain_refs(contigs, genes, fasta, refflat):
    """The genome as fasta (80 columns) and its genes as a refFlat."""
    with open(fasta, "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80].decode() + "\n")
    with open(refflat, "w") as fh:
        for name, chrom, strand, exons in genes:
            s, e = exons[0][0], exons[-1][1]
            fh.write(f"{name}\tT{name}\t{chrom}\t{strand}\t{s}\t{e}\t{s}\t"
                     f"{e}\t{len(exons)}\t"
                     + "".join(f"{a}," for a, _ in exons) + "\t"
                     + "".join(f"{b}," for _, b in exons) + "\n")


def chain_reads(rng, contigs, genes, cells, n_reads, n_big, big_mols=(64, 160),
                big_depth=(1, 2), error_rate=0.04):
    """3p reads of molecules of (cell, gene) groups, each built as a read of
    tests/test_align.py's full-pipeline test: TSO + the transcript (sense)
    + 20 A + UMI + cell barcode + adapter (reverse complements), noise at
    error_rate, a third of the reads reversed. Groups 0..n_big-1 hold
    big_mols molecules of big_depth reads (distinct (cell, gene) pairs);
    every other group 1-8 molecules of 1-4 reads, until n_reads reads.
    Names carry the truth: r<i>g<gene>c<cell>u<group>. Returns (reads
    [(name, seq, qual, group)] shuffled, group -> gene index)."""
    import numpy as np

    from sicelore_tpu_torch.utils import dna, synth
    acgt = np.frombuffer(b"ACGT", np.uint8)
    tx = []
    for name, chrom, strand, exons in genes:
        t = b"".join(contigs[chrom][a:b] for a, b in exons)
        tx.append(t if strand == "+" else dna.revcomp_bytes(t))
    reads, group_gene, used = [], [], set()
    n_cells, n_genes = len(cells), len(genes)
    while len(reads) < n_reads:
        g = len(group_gene)
        while True:
            ci, gi = int(rng.integers(0, n_cells)), int(rng.integers(0,
                                                                  n_genes))
            if (ci, gi) not in used:
                break
        used.add((ci, gi))
        group_gene.append(gi)
        big = g < n_big
        n_mol = int(rng.integers(*big_mols, endpoint=True)) if big \
            else int(rng.integers(1, 9))
        tail = (b"A" * 20)
        bc_rc = dna.revcomp_bytes(cells[ci].encode())
        ad_rc = dna.revcomp_bytes(synth.ADAPTER.encode())
        for _ in range(n_mol):
            umi = acgt[rng.integers(0, 4, 12)].tobytes()
            stranded = (synth.TSO.encode() + tx[gi] + tail
                        + dna.revcomp_bytes(umi) + bc_rc + ad_rc)
            depth = int(rng.integers(*big_depth, endpoint=True)) if big \
                else int(rng.integers(1, 5))
            for _ in range(depth):
                if len(reads) == n_reads:
                    break
                seq = synth.mutate_np(rng, stranded, error_rate)
                if len(reads) % 3 == 0:
                    seq = dna.revcomp_bytes(seq)
                qual = (rng.integers(15, 41, len(seq)) + 33).astype(
                    np.uint8).tobytes()
                reads.append((f"r{len(reads)}g{gi}c{ci}u{g}".encode(), seq,
                              qual, g))
    order = rng.permutation(len(reads))
    return [reads[i] for i in order], group_gene


def write_reads(path, reads):
    with open(path, "wb") as fh:
        for name, seq, qual, _ in reads:
            fh.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))


def chain_truth(aligned_bam, tagged_bam, genes):
    """Against the generator's truth (the gene in each read's name): of the
    primary records, how many map inside their true gene's span on its
    contig, and how many carry their true gene as GE after assignumis.
    Returns (reads in, primary records, mapped to the true gene, GE tags
    equal to the true gene)."""
    from sicelore_tpu_torch.io.bam import BamReader
    from sicelore_tpu_torch.pipeline import readname

    def true_gene(qname):
        info = readname.parse_name(qname)
        o = info.orig_name if info is not None else qname
        return int(o.split("g")[1].split("c")[0])

    n_prim = n_map = 0
    with BamReader(aligned_bam) as rd:
        names = [n for n, _ in rd.header.refs]
        for r in rd:
            if r.flag & 0x904:
                continue
            n_prim += 1
            _, chrom, _, exons = genes[true_gene(r.qname)]
            n_map += (names[r.ref_id] == chrom and r.pos < exons[-1][1]
                      and r.reference_end() > exons[0][0])
    n_ge = 0
    with BamReader(tagged_bam) as rd:
        for r in rd:
            if not r.flag & 0x904:
                n_ge += r.get_tag("GE") == genes[true_gene(r.qname)][0]
    return n_prim, n_map, n_ge


def path_counters():
    """{name: function} of every launch counter: the ten kernel wrappers,
    the composed edge body, the plain bodies (keys starting "plain_"), and
    myers_global_pairwise, the torch body the pairwise kernel's plain
    version calls once a pattern length."""
    from sicelore_tpu_torch.ops import bcsearch, editdist, hostnw_cuda
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import encode_cuda as enc
    from sicelore_tpu_torch.ops import poa_cuda
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
    return {"encode_two_half": enc.encode_two_half_dev,
            "encode_composite": enc.encode_composite_dev,
            "edgescan": edge_scan2, "bcsweep": bcsearch.bc_sweep,
            "tilefeed": ts.tile_feed, "tilescan": ts.tile_scan,
            "win1": editdist.myers_win1, "bandalign": poa_cuda.band_align,
            "hostnw": hostnw_cuda.host_nw,
            "pairwise": editdist.myers_global_group,
            "edge_composed": eg.edge_scan2_composed,
            "myers_global_pairwise": editdist.myers_global_pairwise,
            "plain_encode_two_half": enc.encode_two_half_plain,
            "plain_encode_composite": enc.encode_composite_plain,
            "plain_edgescan": eg.edge_scan2_plain,
            "plain_bcsweep": bcsearch.bc_sweep_plain,
            "plain_tilefeed": ts.tile_feed_plain,
            "plain_tilescan": ts.tile_scan_plain,
            "plain_win1": editdist.myers_win1_plain,
            "plain_bandalign": poa_cuda.band_align_plain,
            "plain_hostnw": hostnw_cuda.host_nw_plain,
            "plain_pairwise": editdist.myers_global_group_plain}


# the launch counters that mean a plain body ran (on the card: none may)
def plain_bodies(launches: dict) -> dict:
    return {k: v for k, v in launches.items()
            if k.startswith("plain_") or k in ("edge_composed", "win1",
                                               "myers_global_pairwise")}


class ShardLaunches:
    """Launches of each kernel (and plain body) made by each shard of a
    mesh: `parallel.shard.map_shards` is wrapped so that every shard's call
    is bracketed by a read of the launch counters (`path_counters`). Used
    as a context manager; `per_shard` is a list of {counter: n > 0}, one a
    shard index."""

    def __init__(self):
        self.per_shard: list[dict] = []

    def __enter__(self):
        from sicelore_tpu_torch.parallel import shard
        counters = path_counters()
        inner = self._inner = shard.map_shards
        per_shard = self.per_shard

        def counted(devices, spans, fn):
            shard_of = iter(range(len(spans)))

            def call(dev, *span):
                i = next(shard_of)
                before = {k: c.launches for k, c in counters.items()}
                out = fn(dev, *span)
                while len(per_shard) <= i:
                    per_shard.append({})
                for k, c in counters.items():
                    if c.launches > before[k]:
                        per_shard[i][k] = (per_shard[i].get(k, 0)
                                           + c.launches - before[k])
                return out
            return inner(devices, spans, call)

        shard.map_shards = counted
        return self

    def __exit__(self, *exc):
        from sicelore_tpu_torch.parallel import shard
        shard.map_shards = self._inner
        return False


MP_RANK = """
import datetime, json, sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
import torch
from sicelore_tpu_torch.parallel import multihost
multihost.init({coord!r}, {n}, {pid}, timeout=datetime.timedelta(seconds=300))
from chip_smoke import path_counters
from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
from sicelore_tpu_torch.utils.config import PipelineConfig
wl = json.loads(Path({wl!r}).read_text())
pipe = ScanFastqPipeline(PipelineConfig(), whitelist=wl,
                         chunk_size={chunk}, user_max_ed=2, cache_pass1=True,
                         device="cuda")
counters = path_counters()
for c in counters.values():
    c.launches = 0
counters["edgescan"].launches_5p = 0
t = time.perf_counter()
stats = pipe.run([{inp!r}], {out!r})
torch.cuda.synchronize()
run_s = time.perf_counter() - t
launches = {{k: c.launches for k, c in counters.items() if c.launches}}
launches["edgescan_5p"] = counters["edgescan"].launches_5p
Path({out!r}, "rank{pid}.json").write_text(json.dumps({{
    "rank": multihost.process_index(), "world": multihost.process_count(),
    "run_s": run_s, "stats": stats.to_json(), "used": pipe.used_strs,
    "launches": launches, "jax": "jax" in sys.modules}}))
"""


def multiprocess_run(inp, out, wl, n=2, timeout=600):
    """`ScanFastqPipeline.run` over `inp` in n processes joined by a gloo
    group (`parallel.multihost`), all on the first card, each started as
    `python -c MP_RANK` with a timeout. Returns ([each rank's record],
    wall seconds from the first start to the last exit); raises
    SystemExit when a rank fails."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        coord = f"localhost:{sk.getsockname()[1]}"
    out.mkdir(parents=True)
    wl_file = out.parent / f"{out.name}_wl.json"
    wl_file.write_text(json.dumps(list(wl)))
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_RANK.format(
            root=str(ROOT), coord=coord, n=n, pid=pid, wl=str(wl_file),
            chunk=READS_PER_FILE, inp=str(inp), out=str(out))],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t
    bad = [f"rank {i} exited {p.returncode}: "
           f"{o[1].decode(errors='replace')[-1500:]}"
           for i, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise SystemExit(f"multiprocess: {bad}")
    ranks = [json.loads((out / f"rank{i}.json").read_text())
             for i in range(n)]
    for i in range(n):
        (out / f"rank{i}.json").unlink()
    return ranks, wall


def output_files(out, skip=("ReadScanner.html",)) -> dict:
    """{relative path: bytes} of every file under out but those named in
    skip."""
    return {str(f.relative_to(out)): f.read_bytes()
            for f in sorted(Path(out).rglob("*"))
            if f.is_file() and f.name not in skip}


def tag_and_consensus(device, wf, out) -> dict:
    """tagbamwithread and computeconsensus (the device engine on `device`)
    over a `run` output directory's umi.bam and readscan/passed: the
    chained phase's Step 4b on the run phase's subset. Returns
    {file: bytes}."""
    from sicelore_tpu_torch.pipeline import programs
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus
    out.mkdir(parents=True)
    programs.tag_bam_with_read(wf / "umi.bam", out / "umi_us.bam",
                               wf / "readscan" / "passed")
    compute_consensus(out / "umi_us.bam", out / "consensus.fastq",
                      device=device, log_json=out / "consensus.fastq.log")
    return output_files(out)


def chain_steps(device, fastq_dir, ref, refflat, wl, out, on_step=None):
    """Steps 1 -> 2 -> 3 -> 4b of the port on `device`, each through its
    library entry point: scanfastq, align, assignumis (with the refFlat),
    tagbamwithread (the cDNA source of computeconsensus), computeconsensus.
    Every launch count is zeroed just before a step and read just after;
    on_step(name) is called before each step. Returns ({step: {"s",
    "launches", "result"}}, {relative path: bytes} of every output file
    but the HTML scan report)."""
    from sicelore_tpu_torch.align import NativeAligner
    from sicelore_tpu_torch.pipeline import programs
    from sicelore_tpu_torch.pipeline.assignumis import AssignUmisPipeline
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus
    from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
    from sicelore_tpu_torch.utils.config import PipelineConfig
    passed, aligned = out / "scan" / "passed", out / "aligned.bam"
    umi, umi_us = out / "umi.bam", out / "umi_us.bam"
    todo = (
        ("scanfastq", lambda: ScanFastqPipeline(
            PipelineConfig(), whitelist=wl, chunk_size=8_192,
            device=device).run([fastq_dir], out / "scan").to_json()),
        ("align", lambda: NativeAligner(ref, device=device)
         .align_fastq_to_bam(passed, aligned)),
        ("assignumis", lambda: AssignUmisPipeline(
            refflat=refflat, device=device).run(
            aligned, umi, genecounts_tsv=out / "umi.genecounts.tsv",
            umidepths_tsv=out / "umi.UMIdepths.tsv",
            log_json=out / "umi.bam.log").to_json()),
        ("tagbamwithread", lambda: programs.tag_bam_with_read(umi, umi_us,
                                                              passed)),
        ("computeconsensus", lambda: compute_consensus(
            umi_us, out / "consensus.fastq", device=device,
            log_json=out / "consensus.fastq.log")))
    counters = path_counters()
    steps = {}
    for name, fn in todo:
        if on_step is not None:
            on_step(name)
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        res = fn()
        if str(device) == "cuda":
            import torch
            torch.cuda.synchronize()
        steps[name] = {"s": time.perf_counter() - t, "result": res,
                       "launches": {k: c.launches for k, c in
                                    counters.items() if c.launches}}
    files = {str(f.relative_to(out)): f.read_bytes()
             for f in sorted(out.rglob("*")) if f.is_file()
             and f.name != "ReadScanner.html"}
    return steps, files


class _StageClock:
    """A stdout stand-in that keeps each line `run` prints with the time it
    was written: the stage lines "[name] running..." / "[name] resume: ..."
    give each stage's seconds."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def flush(self):
        pass


def run_workflow(device, fastq_dir, ref, refflat, wl_file, out,
                 consensus=False):
    """The port's `run` (-b 2 --nativeAlign --collapse, with --consensus if
    asked; `-b 2` caps the barcode edit distance where the chained phase's
    library calls take the dynamic table's) on `device`, through its CLI in
    this process, so that the launch
    counters are read around it: every count is zeroed just before and read
    just after. Returns {"rc", "s", "stage_s" {stage: seconds}, "resumed"
    [stages skipped], "launches" {counter: n > 0; "edgescan_5p": the edge
    launches made with 5p parameters, a share of "edgescan"}, "printed"
    [lines],
    "files" {relative path: bytes} of every file under `out`}."""
    import contextlib

    from sicelore_tpu_torch import __main__ as cli
    argv = ["run", "-d", str(fastq_dir), "-r", str(ref), "-a", str(refflat),
            "-o", str(out), "--whitelist", str(wl_file), "-b", "2",
            "--nativeAlign", "--collapse", "--device", str(device)]
    if consensus:
        argv.append("--consensus")
    counters = path_counters()
    for c in counters.values():
        c.launches = 0
    counters["edgescan"].launches_5p = 0
    clock = _StageClock()
    t = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        rc = cli.main(argv)
        if str(device) == "cuda":
            import torch
            torch.cuda.synchronize()
    end = time.perf_counter()
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    if counters["edgescan"].launches_5p:
        launches["edgescan_5p"] = counters["edgescan"].launches_5p
    stages = [(ts, line[1:line.index("]")], "resume" in line)
              for ts, line in clock.lines if line.startswith("[")
              and ("] running" in line or "] resume" in line)]
    stage_s = {name: (stages[i + 1][0] if i + 1 < len(stages) else end) - ts
               for i, (ts, name, _) in enumerate(stages)}
    return {"rc": rc, "s": end - t, "stage_s": stage_s,
            "resumed": [name for _, name, skip in stages if skip],
            "launches": launches, "printed": [l for _, l in clock.lines],
            "files": {str(f.relative_to(out)): f.read_bytes()
                      for f in sorted(Path(out).rglob("*")) if f.is_file()}}


def workflow_phase(device, cdir, ref, refflat, wl, genes, n_sub):
    """The `run` phase (see the module docstring): the port's `run
    --nativeAlign --collapse` on `device` over the chained phase's inputs
    under `cdir` (fq/, sub/ of n_sub reads), checked against the
    generator's truth (genes); the subset with --consensus on `device` and
    on cpu, byte for byte; the subset again on its own output, where every
    stage must resume and nothing launch. Emits the phase's line and
    raises SystemExit on a failed check; returns (the line, the main
    run_workflow result)."""
    from sicelore_tpu_torch.core import umicluster
    t0 = time.time()
    ed_calls = []
    inner_ed = umicluster._pairwise_ed_device

    def record_ed(umis, dev="cuda"):
        ed_calls.append((str(dev), len(umis)))
        return inner_ed(umis, dev)

    n_reads = (cdir / "fq" / "reads.fastq").read_bytes().count(b"\n") // 4
    wl_file = cdir / "wl.txt"
    wl_file.write_text("".join(w + "\n" for w in wl))
    umicluster._pairwise_ed_device = record_ed
    try:
        wf = run_workflow(device, cdir / "fq", ref, refflat, wl_file,
                          cdir / "wf")
    finally:
        umicluster._pairwise_ed_device = inner_ed
    n_prim, n_map, n_ge = chain_truth(cdir / "wf" / "passed.sorted.bam",
                                      cdir / "wf" / "umi.bam", genes)
    gm = wf["files"]["isomatrix/sicelore_genematrix.txt"].decode(
        ).splitlines()
    passed_reads = sum(b.count(b"\n") // 4 for k, b in wf["files"].items()
                       if k.startswith("readscan/passed/"))
    wf_res = json.loads(wf["files"]["pipeline_results.json"])
    run_ph = {
        "phase": "run", "reads": n_reads, "rc": wf["rc"],
        "stage_s": {k: round(v, 3) for k, v in wf["stage_s"].items()},
        "run_s": round(wf["s"], 3), "passed_reads": passed_reads,
        "align_reads_per_s": round(passed_reads / wf["stage_s"]["minimap2"],
                                   1),
        "launches": wf["launches"], "device_ed_calls": len(ed_calls),
        "device_ed_devices": sorted({d for d, _ in ed_calls}),
        "aligned_records": wf_res.get("aligned_records"),
        "matrix_genes": len(gm) - 1,
        "matrix_cells": len(gm[0].split("\t")) - 1 if gm else 0,
        "collapse": {k: v for k, v in wf_res.get("collapse", {}).items()
                     if not isinstance(v, (list, dict))},
        "primary_records": n_prim,
        "true_gene_share": n_map / max(n_prim, 1),
        "ge_share": n_ge / max(n_prim, 1), "files": len(wf["files"])}
    bad = []
    ln = wf["launches"]
    if wf["rc"] != 0:
        bad.append(f"run exited {wf['rc']}")
    if min(ln.get(k, 0) for k in ("edgescan", "bcsweep", "tilefeed",
                                  "tilescan", "bandalign")) < 1:
        bad.append("run did not launch its kernels")
    if ln.get("pairwise", 0) < 1 or ln["pairwise"] != len(ed_calls) or \
            {d for d, _ in ed_calls} != {device}:
        bad.append(f"run's assignumis launched the pairwise kernel "
                   f"{ln.get('pairwise', 0)} times for {len(ed_calls)} "
                   f"batched groups")
    plain = plain_bodies(ln)
    if plain:
        bad.append(f"plain bodies ran: {plain}")
    if (n_prim < 0.95 * passed_reads
            or run_ph["true_gene_share"] < CHAIN_MIN_SHARE
            or run_ph["ge_share"] < CHAIN_MIN_SHARE
            or run_ph["matrix_genes"] < 1 or run_ph["matrix_cells"] < 1):
        bad.append("run outputs off the generator's truth")
    # the subset with --consensus: CUDA == CPU bytes in every file; then
    # the CUDA run again on its own output directory: every stage resumes
    # and nothing launches
    sub = {d: run_workflow(d, cdir / "sub", ref, refflat, wl_file,
                           cdir / f"wf_{d}", consensus=True)
           for d in (device, "cpu")}
    diff = sorted(k for k in set(sub[device]["files"])
                  | set(sub["cpu"]["files"])
                  if sub[device]["files"].get(k)
                  != sub["cpu"]["files"].get(k))
    again = run_workflow(device, cdir / "sub", ref, refflat, wl_file,
                         cdir / f"wf_{device}", consensus=True)
    run_ph.update({
        "parity_reads": n_sub, "parity_files": len(sub[device]["files"]),
        "parity_differ": diff,
        "parity_stage_s": {d: {k: round(v, 3) for k, v in
                               sub[d]["stage_s"].items()} for d in sub},
        "resume_stages": again["resumed"], "resume_launches":
            again["launches"], "resume_s": round(again["s"], 3),
        "s": round(time.time() - t0, 2)})
    emit(run_ph)
    if diff or len(sub[device]["files"]) < 30 or sub[device]["rc"] or \
            sub["cpu"]["rc"]:
        bad.append(f"cuda/cpu run outputs differ: {diff}")
    if again["rc"] or again["launches"] or \
            again["resumed"] != list(sub[device]["stage_s"]) or \
            len(again["resumed"]) != 8:
        bad.append(f"resume ran stages {again['stage_s']} or launched "
                   f"{again['launches']}")
    if bad:
        raise SystemExit(f"run: {bad}")
    return run_ph, wf


def gap_pairs(rng, Lc, n):
    """(R, Q) pairs of the aligner's Lc bucket: R of Lc/2 + 1 .. Lc bases
    (1 .. 64 at Lc 64), Q a copy at 5% noise whose length differs from R's
    by up to W/2 - 5; every 16th pair differs by W/2 - 4 .. W (outside the
    band: infeasible) and every 37th has an empty Q."""
    import numpy as np

    from sicelore_tpu_torch.ops import poa_cuda
    from sicelore_tpu_torch.utils import synth
    acgt = np.frombuffer(b"ACGT", np.uint8)
    W = poa_cuda.w_for(Lc)
    lo = 1 if Lc == 64 else Lc // 2 + 1
    pairs = []
    for i in range(n):
        R = acgt[rng.integers(0, 4, int(rng.integers(lo, Lc + 1)))].tobytes()
        Q = synth.mutate_np(rng, R, 0.05)
        d = (int(rng.integers(W // 2 - 4, W + 1)) if i % 16 == 5
             else int(rng.integers(0, W // 2 - 4)))
        d = d if rng.random() < 0.5 or len(R) <= d else -d
        want = max(len(R) + d, 0)
        Q = (Q + acgt[rng.integers(0, 4, max(want - len(Q), 0))].tobytes()
             )[:want]
        pairs.append((R, b"" if i % 37 == 3 else Q))
    return pairs


HOSTNW_CASES = ("equal", "short_read", "tiny", "n_lower", "all_n", "repeats",
                "band_edge", "longer_read", "empty")


def hostnw_pairs(name: str, seed: int = SEED + 1_100) -> list:
    """(center, read) pairs of the host engine's alignment (csrc/hostnw.cu)
    by kind, centers of at most 300 nt: equal lengths; reads of at most half
    the center; reads of 1-3 bases; N and lower-case bytes; all-N reads;
    tandem repeats and homopolymers, whose tied scores test the move order;
    rotations and long indels whose paths run along the band's edge (the
    walk reads cells outside the windows there); reads longer than the
    center; empty centers and reads (the host's early returns)."""
    import numpy as np

    from sicelore_tpu_torch.utils import synth
    rng = np.random.default_rng([seed, HOSTNW_CASES.index(name)])

    def rand(n, alphabet=b"ACGT"):
        return np.frombuffer(alphabet, np.uint8)[
            rng.integers(0, len(alphabet), n)].tobytes()

    def noisy(s, rate=0.04):
        return synth.mutate_np(rng, s, rate)

    if name == "equal":
        out = []
        for n in (40, 120, 250, 300):
            a = rand(n)
            b = bytearray(noisy(a, 0.03)[:n])
            b += rand(n - len(b))
            out += [(a, bytes(b)), (a, a)]
        return out
    if name == "short_read":
        out = []
        for n in (80, 200, 300):
            a = rand(n)
            s = int(rng.integers(0, n // 2))
            out += [(a, noisy(a[s:s + n // 2 - 3])), (a, rand(n // 3)),
                    (a, noisy(a[: n // 5])), (a, noisy(a[-n // 4:]))]
        return out
    if name == "tiny":
        a = rand(200)
        return ([(a, rand(k)) for k in (1, 2, 3)]
                + [(a[:k], rand(j)) for k in (1, 2, 3) for j in (1, 2, 3)]
                + [(a, a[100:101]), (a, a[:3]), (a, a[-2:])])
    if name == "n_lower":
        out = []
        for n in (90, 260):
            a = bytearray(rand(n, b"ACGTN"))
            b = bytearray(noisy(bytes(a).replace(b"N", b"A")))
            for x in rng.integers(0, len(b), 6):
                b[x] = ord("N")
            low = bytes(b).lower()
            out += [(bytes(a), bytes(b)), (bytes(a), low),
                    (bytes(a).lower(), bytes(b)), (rand(n, b"ACGTacgtN"),
                                                   rand(n - 7, b"ACGTacgtN"))]
        return out
    if name == "all_n":
        a = rand(220)
        return [(a, b"N" * 200), (b"N" * 150, b"N" * 140), (b"N" * 60, a[:60]),
                (a, b"N" * 3), (b"N" * 300, b"N" * 300)]
    if name == "repeats":
        return [(b"AC" * 60, b"AC" * 45), (b"AC" * 45 + b"G", b"AC" * 60),
                (b"A" * 200, b"A" * 150), (b"A" * 150, b"A" * 151),
                (b"ACG" * 80, b"ACG" * 70 + b"AC"), (b"AAAT" * 50,
                                                      b"AAT" * 60),
                (b"AC" * 100, b"CA" * 100), (b"T" * 90 + b"A" * 90,
                                              b"A" * 90 + b"T" * 90)]
    if name == "band_edge":
        out = []
        for n in (200, 300):
            x, y = rand(n // 2), rand(n // 2)
            out += [(x + y, y + x), (x + y, noisy(y) + noisy(x)),
                    (x + y, y + rand(n // 2)), (x + rand(90) + y, x + y),
                    (x + y, x + rand(90) + y)]
        return out
    if name == "longer_read":
        out = []
        for n, m in ((60, 250), (150, 300), (30, 200), (5, 90)):
            a = rand(n)
            out += [(a, noisy(a) + rand(m - n)), (a, rand(m))]
        return out
    if name == "empty":
        return [(b"", b""), (b"", b"ACG"), (b"ACGT", b""), (rand(250), b""),
                (b"", rand(40))]
    raise ValueError(f"no host-alignment case {name!r}")


def hostnw_packed(pairs):
    """The pairs' bytes in one buffer and their offsets and lengths, as
    `hostnw_cuda.align_pairs` takes them: (seq, a_off, la, b_off, lb)."""
    import numpy as np
    seq, a_off, b_off = bytearray(), [], []
    for a, b in pairs:
        a_off.append(len(seq))
        seq += a
        b_off.append(len(seq))
        seq += b
    return (np.frombuffer(seq, np.uint8), a_off, [len(a) for a, _ in pairs],
            b_off, [len(b) for _, b in pairs])


def hostnw_aligned(a: bytes, b: bytes, moves) -> tuple[bytes, bytes]:
    """The aligned strings of a pair's moves (stored from the end), as
    `poa.nw_align_banded` returns them."""
    import numpy as np
    ra, rb = bytearray(), bytearray()
    i = j = 0
    for m in np.asarray(moves)[::-1]:
        ra.append(a[i] if m != 2 else 45)
        rb.append(b[j] if m != 1 else 45)
        i += m != 2
        j += m != 1
    if (i, j) != (len(a), len(b)):
        raise ValueError(f"moves end at ({i}, {j}), not ({len(a)}, {len(b)})")
    return bytes(ra), bytes(rb)


def host_molecules(rng, kind: str) -> list:
    """Molecules the batched engine leaves to the host engine, in the
    benchmark's cells' make-up: `wta`: 25 of 3-12 reads of 400-899 nt at
    3% with an N in one read and four of 3-12 reads of 2,100-2,250 nt;
    `deep`: 20 of 13-20 reads with an N and four long ones of 13-20 reads;
    both with 40 molecules of one or two reads."""
    from sicelore_tpu_torch.utils import synth
    deep = kind == "deep"
    mols = []
    for i in range(29 if not deep else 24):
        depth = int(rng.integers(13, 21) if deep else rng.integers(3, 13))
        long = i >= (25 if not deep else 20)
        length = int(rng.integers(2_100, 2_251) if long
                     else rng.integers(400, 900))
        reads = synth.molecule_set(rng, 1, depth, 0.03, length)[0][0]
        if not long:
            r = int(rng.integers(0, depth))
            s = bytearray(reads[r])
            s[int(rng.integers(0, len(s)))] = ord("N")
            reads[r] = bytes(s)
        mols.append(reads)
    for i in range(40):
        mols += synth.molecule_set(rng, 1, 1 + i % 2, 0.03, 500)[0]
    return mols


def hostnw_star_pairs(mols) -> list:
    """The (center, read) pairs `hostnw_cuda.CenterStar` aligns for the
    molecules of three or more reads: each one's longest read (the first of
    equal length) against every other."""
    out = []
    for m in mols:
        if len(m) > 2:
            c = max(range(len(m)), key=lambda i: len(m[i]))
            out += [(m[c], s) for r, s in enumerate(m) if r != c]
    return out


def hostnw_band_cells(la, lb) -> int:
    """The cells of every pair's row windows (the host's band and
    rounding)."""
    import numpy as np
    total = 0
    for a, b in zip(np.asarray(la).tolist(), np.asarray(lb).tolist()):
        if a and b:
            band = max(32, abs(a - b) + max(a, b) // 10)
            c = np.rint(np.arange(1, a + 1) * (b / a)).astype(np.int64)
            w = np.minimum(b, c + band) - np.maximum(1, c - band) + 1
            total += int(np.maximum(w, 0).sum())
    return total


def hostnw_phase(dev, int32_hz) -> dict:
    """csrc/hostnw.cu against its plain version on the card, move for
    move, at the pair sets of a wta- and a deep-like Step 4b call
    (`host_molecules`), with variants of fresh content (one base in a
    thousand replaced); the wrapper's ms (CUDA events around a call, the
    median of TIMED_CALLS), its device_ms and burst_ms; the bound: the band
    cells x HOSTNW_CELL_OPS int32 operations or the bytes read and written
    once, the score rows' scratch bytes beside it. `hostnw_route`: host ms
    of the whole path a call takes for those molecules (`CenterStar`, then
    `poa.consensus_from_msa` a molecule) against `poa.consensus_reads` on
    them, and the molecules whose answers differ. Returns {result key:
    entry}."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    from sicelore_tpu_torch.ops import poa
    res, route = {}, {"mismatches": 0}
    for kind in ("wta", "deep"):
        rng = np.random.default_rng([SEED + 1_200, len(kind)])
        mols = host_molecules(rng, kind)
        seq, a_off, la, b_off, lb = hostnw_packed(hostnw_star_pairs(mols))
        table = hn.pair_table(a_off, la, b_off, lb)
        table_d = torch.from_numpy(table).to(dev)
        seq_d = torch.from_numpy(seq.copy()).to(dev)
        acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)

        def variant():
            v = seq_d.clone()
            at = torch.from_numpy(rng.integers(0, len(seq), len(seq) // 1000))
            v[at.to(dev)] = acgt[torch.from_numpy(
                rng.integers(0, 4, len(at))).to(dev)]
            return v

        def kern(v):
            return hn.host_nw(v, table_d, table)

        # a pair's bytes past its n_moves are not written: zero them on
        # both sides before the comparison
        lens = table[:, 1] + table[:, 3]
        pid = torch.from_numpy(np.repeat(np.arange(len(table)), lens)).to(dev)
        rel = torch.from_numpy(np.arange(int(lens.sum()))
                               - np.repeat(table[:, 5], lens)).to(dev)

        def written(out):
            mv, n = out
            return torch.where(rel < n.long()[pid], mv, 0), n

        vars_ = [seq_d] + [variant() for _ in range(TIMED_CALLS)]
        key = f"hostnw_{kind}"
        res[key] = compare(
            key, lambda v: written(kern(v)),
            lambda v: written(hn.host_nw_plain(v, table_d, table)),
            vars_[:HOSTNW_PLAIN_CALLS])
        res[key]["ms"] = timed(kern, vars_[1:], torch.cuda.synchronize)[0]
        cells = hostnw_band_cells(table[:, 1], table[:, 3])
        res[key].update(bound(
            seq.nbytes + table.nbytes + int((table[:, 1] + table[:, 3]).sum())
            + 4 * len(table), cells * HOSTNW_CELL_OPS, int32_hz))
        res[key].update({
            "pairs": len(table), "band_cells": cells,
            "center_lengths": [int(table[:, 1].min()),
                               int(table[:, 1].max())],
            "scratch_bytes": 4 * int((table[:, 1] * hn.strides(
                table[:, 1], table[:, 3])).sum()),
            "device_ms": device_ms(kern, vars_[1:]),
            "burst_ms": burst_ms(kern, vars_[1:])})
        host = [m for m in mols if len(m) > 2]
        ms = []
        for _ in range(3):
            t = time.perf_counter()
            star = hn.CenterStar(host, dev)
            got = [poa.consensus_from_msa(star.rows(m), 20)
                   for m in range(len(host))]
            ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        want = [poa.consensus_reads(m, 3, 20) for m in host]
        route[f"host_engine_ms_{kind}"] = (time.perf_counter() - t) * 1e3
        route[f"route_ms_{kind}"] = sorted(ms)[1]
        route[f"molecules_{kind}"] = len(host)
        route["mismatches"] += sum(g != w for g, w in zip(got, want))
        del seq_d, table_d, vars_, pid, rel
        torch.cuda.empty_cache()
    res["hostnw_route"] = route
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from sicelore_tpu_torch.utils import synth

    # synthetic inputs and outputs (~1 GB): inside the checkout, removed
    # at the end
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    (work / "run").mkdir(parents=True)
    (work / "run5p").mkdir()
    dev = torch.device("cuda")

    # ---- env (+ data generation in worker processes meanwhile) ----
    rng = np.random.default_rng(SEED)
    wl = synth.make_whitelist(rng, N_WHITELIST)
    cells = [wl[i] for i in sorted(rng.choice(N_WHITELIST, N_CELLS,
                                              replace=False).tolist())]
    pool = mp.get_context("spawn").Pool(2 * N_FILES)
    try:
        return _run(pool, wl, cells, work, dev)
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)


def _run(pool, wl, cells, work, dev) -> int:
    import numpy as np
    import torch

    from sicelore_tpu_torch.io import fastq, native
    from sicelore_tpu_torch.utils import dna, synth
    from sicelore_tpu_torch.utils.config import PipelineConfig
    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import _build, bcsearch, editdist
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import encode_cuda as enc
    from sicelore_tpu_torch.ops import hostnw_cuda, poa_cuda, scan
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus
    from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline

    t0 = time.time()
    gen = pool.map_async(make_file, [
        (str(work / run / f"reads{i}.fastq"), SEED + off + i, cells, chem)
        for run, off, chem in (("run", 1, "3p"), ("run5p", 301, "5p"))
        for i in range(N_FILES)])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_hz = sms * INT32_LANES_PER_SM * sm_hz
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip(
                              ).splitlines()[-1] if nvcc else None
    _build.build_all()
    for stem in ("encode", "edgescan", "bcsweep", "tilefeed", "tilescan",
                 "bandalign", "win1", "pairwise"):
        _build.load(stem)
    emit({"phase": "env", "nvidia_smi": smi, "max_sm_mhz": sm_hz / 1e6,
          "sms": sms,
          "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_ver,
          "gpu": torch.cuda.get_device_name(0),
          "hostenc": native.get_hostenc() is not None,
          "build_s": _build.build_seconds, "s": round(time.time() - t0, 2)})

    t0 = time.time()
    gen.get(timeout=900)
    emit({"phase": "data", "reads": 2 * N_FILES * READS_PER_FILE,
          "files": 2 * N_FILES, "whitelist": N_WHITELIST, "cells": N_CELLS,
          "s": round(time.time() - t0, 2)})

    # ---- kernels vs plain at the main path's shapes ----
    t0 = time.time()
    cfg = PipelineConfig()
    chunk = next(fastq.read_fastq(work / "run" / "reads0.fastq",
                                  READS_PER_FILE))
    B = len(chunk)
    codes_np, _, lens, _ = eg.encode_two_half(chunk.seqs, chunk.quals)
    codes = torch.from_numpy(codes_np).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    cfg5 = PipelineConfig(chemistry="5p")
    ep5 = eg.edge_params(cfg5)
    chunk5 = next(fastq.read_fastq(work / "run5p" / "reads0.fastq",
                                   READS_PER_FILE))
    codes5_np, _, lens5, _ = eg.encode_two_half(chunk5.seqs, chunk5.quals)
    codes5 = torch.from_numpy(codes5_np).to(dev)
    lens5_d = torch.from_numpy(lens5).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    # the read encoding on both chunks (the main path's chunks) and its
    # edge set, first: its rows feed every scan below on the main path
    results = encode_phase(dev, {"3p": (chunk.seqs, chunk.quals),
                                 "5p": (chunk5.seqs, chunk5.quals)},
                           int32_hz)

    def mutate_reads(ct, ld):
        """One substituted base per read, inside the read (fresh content)."""
        ct = ct.clone()
        n = ct.shape[0]
        ar = torch.arange(n, device=dev)
        col = (torch.rand(n, device=dev, generator=g)
               * torch.clamp(ld, 1, eg.E)).long()
        col = torch.where(torch.rand(n, device=dev, generator=g) < 0.5, col,
                          2 * eg.E - 1 - col)
        val = torch.randint(0, 4, (n,), device=dev, generator=g,
                            dtype=torch.int8)
        keep = ct[ar, col] != dna.PAD
        ct[ar[keep], col[keep]] = val[keep]
        return ct

    ep = eg.edge_params(cfg)
    for key, c0, ld, pe in (("edgescan", codes, lens_d, ep),
                            ("edgescan_5p", codes5, lens5_d, ep5)):
        # the bound from the chunk as it is (each variant differs from it
        # by one base a read: its work stands for all)
        if pe.k != 15:
            raise SystemExit(f"EDGE_WORD_OPS counts k = 15, not {pe.k}")
        ework = edge_scan_work(c0, ld, pe)
        evars = [c0] + [mutate_reads(c0, ld) for _ in range(TIMED_CALLS)]
        results[key] = compare(
            key, lambda c: edge_scan2(c, ld, pe),
            lambda c: eg.edge_scan2_plain(c[:, :eg.E], c[:, eg.E:], ld, pe),
            evars)
        results[key].update(bound(ework["bytes"], ework["operations"],
                                  int32_hz))
        results[key].update({"reads": c0.shape[0],
                             "ops_per_read": ework["operations"]
                             / c0.shape[0],
                             **{k: ework[k] for k in (
                                 "scan_columns", "scan_words",
                                 "window_columns", "adapter_columns",
                                 "used_columns", "tso_columns")}})
        results[key]["device_ms"] = device_ms(
            lambda c: edge_scan2(c, ld, pe), evars[1:])
        results[key]["burst_ms"] = burst_ms(
            lambda c: edge_scan2(c, ld, pe), evars[1:])
        del evars
    # the reads the kernel's words, windows and blocks could get wrong, in
    # launches of 1, 37, 129 reads and all of them
    edge_set = {}
    for chem, pe in (("3p", ep), ("5p", ep5)):
        seqs, quals = edge_set_reads(np.random.default_rng(SEED + 700), chem)
        c_np, _, l_np, _ = eg.encode_two_half(seqs, quals)
        for n in (1, 37, 129, len(seqs)):
            got = edge_scan2(torch.from_numpy(c_np[:n]).to(dev),
                             torch.from_numpy(l_np[:n]).to(dev), pe)
            ref = eg.edge_scan2_plain(torch.from_numpy(c_np[:n, :eg.E]),
                                      torch.from_numpy(c_np[:n, eg.E:]),
                                      torch.from_numpy(l_np[:n]), pe)
            edge_set[f"{chem}_b{n}"] = int((got.cpu() != ref).sum())
    results["edgescan_edge_cases"] = {
        "mismatches": sum(edge_set.values()),
        **{chem: sum(v for k, v in edge_set.items() if k.startswith(chem))
           for chem in ("3p", "5p")},
        "cases": edge_set}
    meta = edge_scan2(codes, lens_d, ep)
    wins = meta[eg.ROW_BC0:].to(torch.uint8).contiguous()

    def mutate_wins(w):
        w = w.clone()
        r = torch.randint(0, w.shape[0], (B,), device=dev, generator=g)
        w[r, torch.arange(B, device=dev)] = torch.randint(
            0, 4, (B,), device=dev, generator=g, dtype=torch.uint8)
        return w

    wvars = [mutate_wins(wins) for _ in range(TIMED_CALLS)]
    m = cfg.barcodes.cell_bc_length
    cell_set = set(cells)
    others = [w for w in wl if w not in cell_set]
    n_small = SWEEP_SMALL_B
    wsmall = [w[:, :n_small].contiguous() for w in wvars]
    for n_bc in SWEEP_LISTS:
        pats, _ = dna.encode_batch([s.encode() for s in
                                    (cells + others)[:n_bc]], m)
        peq = bcsearch.peq_device(editdist.build_peq(pats), dev)
        key = f"bcsweep_{n_bc}"
        results[key] = compare(
            f"bcsweep[{n_bc}]",
            lambda w: bcsearch.bc_sweep(w, peq, n_bc, m, track_pos=True),
            lambda w: bcsearch.bc_sweep_plain(w, peq, n_bc, m,
                                              track_pos=True),
            wvars)
        sweep_ops = B * n_bc * wins.shape[0] * MYERS_OPS
        results[key].update(bound(nbytes(wins, peq) + 4 * B * 4, sweep_ops,
                                  int32_hz))
        S, L = bcsearch.sweep_slices(
            B, n_bc, n_bc, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        results[key].update({"slices": S, "slice_barcodes": L})
        # the main path's call: no end position. The plain version runs at
        # the small list only; at the large one the rows are held against
        # the (verified) kernel rows with the position, whose first three
        # are the same function.
        key_np = f"bcsweep_{n_bc}_nopos"
        if n_bc == SWEEP_LISTS[0]:
            results[key_np] = compare(
                f"bcsweep[{n_bc}, no pos]",
                lambda w: bcsearch.bc_sweep(w, peq, n_bc, m, track_pos=False),
                lambda w: bcsearch.bc_sweep_plain(w, peq, n_bc, m,
                                                  track_pos=False),
                wvars)
        else:
            ms_np, outs = timed(
                lambda w: bcsearch.bc_sweep(w, peq, n_bc, m, track_pos=False),
                wvars, torch.cuda.synchronize)
            bad = 0
            for w, o in zip(wvars, outs):
                ref = bcsearch.bc_sweep(w, peq, n_bc, m, track_pos=True)
                bad += int((o[:3] != ref[:3]).sum() + (o[3] != -1).sum())
            results[key_np] = {"mismatches": bad, "max_abs_err": bad and 1,
                               "ms": ms_np, "plain_ms": None,
                               "calls": len(wvars),
                               "held_against": "kernel rows with track_pos"}
        results[key_np].update(bound(nbytes(wins, peq) + 4 * B * 4,
                                     sweep_ops, int32_hz))
        for tag, track in (("", True), ("_nopos", False)):
            results[f"bcsweep_{n_bc}{tag}"]["device_ms"] = device_ms(
                lambda w: bcsearch.bc_sweep(w, peq, n_bc, m, track_pos=track),
                wvars)
        # the merge kernel alone, over partials of this launch's grid
        parts = [torch.randint(0, m + 1, (S, 4, B), device=dev, generator=g,
                               dtype=torch.int32) for _ in range(TIMED_CALLS)]
        results[key]["merge_device_ms"] = device_ms(
            bcsearch.merge_sweep_partials, parts)
        del parts
        if n_bc == SWEEP_LISTS[0]:
            # a small launch (a split rescan's size): the grid's slices must
            # keep the card full
            for tag, track in (("", True), ("_nopos", False)):
                k4 = f"bcsweep_{n_bc}_b{n_small}{tag}"
                results[k4] = compare(
                    k4,
                    lambda w: bcsearch.bc_sweep(w, peq, n_bc, m,
                                                track_pos=track),
                    lambda w: bcsearch.bc_sweep_plain(w, peq, n_bc, m,
                                                      track_pos=track),
                    wsmall)
                results[k4].update(bound(
                    nbytes(wsmall[0], peq) + 4 * n_small * 4,
                    n_small * n_bc * wins.shape[0] * MYERS_OPS, int32_hz))
                results[k4]["device_ms"] = device_ms(
                    lambda w: bcsearch.bc_sweep(w, peq, n_bc, m,
                                                track_pos=track), wsmall)
    edge_cases = sweep_edge_cases(dev)
    results["bcsweep_edge_cases"] = {
        "mismatches": sum(edge_cases.values()), "cases": edge_cases}
    rows, _, _ = readscan.build_tiles(chunk.seqs, cfg)
    rows_d = torch.tensor(rows, device=dev)
    tp = ts.tile_params(cfg)

    def mutate_tiles(r):
        r = r.clone()
        T = r.shape[0]
        c = torch.randint(0, 256, (T,), device=dev, generator=g)
        r[torch.arange(T, device=dev), c] = torch.randint(
            0, 4, (T,), device=dev, generator=g, dtype=torch.uint8) * 17
        return r

    tvars = [rows_d] + [mutate_tiles(rows_d) for _ in range(TIMED_CALLS)]
    # the bound first, from the plain detection over these tiles (each
    # variant differs from the chunk's tiles by one base a tile: the first
    # variant's work stands for all)
    n_tiles = int(rows.shape[0])
    if tp.k != 15:
        raise SystemExit(f"TILE_WORD_OPS counts k = 15, the run has {tp.k}")
    words, sites, row_bytes = tile_scan_work(rows_d, tp)
    tile_bound = bound(row_bytes + 3 * n_tiles * 4,
                       words * TILE_WORD_OPS
                       + sites * ts.WI_CONFIRM * MYERS_OPS, int32_hz)
    tile_bound.update({"words": words, "sites": sites})
    results["tilescan"] = compare(
        "tilescan", lambda r: ts.tile_scan(r, tp),
        lambda r: ts.tile_scan_plain(r, tp), tvars)
    results["tilescan"].update(tile_bound)
    results["tilescan"]["device_ms"] = device_ms(
        lambda r: ts.tile_scan(r, tp), tvars[1:])
    results["tilescan"]["burst_ms"] = burst_ms(
        lambda r: ts.tile_scan(r, tp), tvars[1:])
    del tvars
    # the tiles the kernel's words, lanes and blocks could get wrong, in
    # one launch of TILE_EDGE_N tiles and one of a single tile
    edge_rows = torch.from_numpy(tile_edge_rows(TILE_EDGE_N))
    results["tilescan_edge_cases"] = {"mismatches": sum(
        int((ts.tile_scan(r.to(dev), tp).cpu()
             != ts.tile_scan_plain(r, tp)).sum())
        for r in (edge_rows, edge_rows[6:7].clone(), edge_rows[1:2].clone()))}

    # the tile feed over the chunk's covered reads (the fused route's
    # index and rows, fresh content each call), its edge set in launches of
    # 1, 37 and all (every read's index, covered or not), rows at an
    # unaligned offset, and the chimera scan over what it writes
    fvars = [codes] + [mutate_reads(codes, lens_d)
                       for _ in range(TIMED_CALLS)]
    cov_d = covered_index(lens, tp, dev)
    n_cov = int(cov_d.shape[0])
    results["tilefeed"] = compare(
        "tilefeed", lambda c: ts.tile_feed(c, lens_d, cov_d, tp),
        lambda c: ts.tile_feed_plain(c, lens_d, cov_d, tp), fvars)
    results["tilefeed"].update(bound(
        int(lens_d.long()[cov_d.long()].sum()) + 2 * 4 * n_cov
        + ts.ROW_BYTES * n_cov, 0, int32_hz))
    results["tilefeed"].update({"reads": B, "covered": n_cov})
    results["tilefeed"]["device_ms"] = device_ms(
        lambda c: ts.tile_feed(c, lens_d, cov_d, tp), fvars[1:])
    results["tilefeed"]["burst_ms"] = burst_ms(
        lambda c: ts.tile_feed(c, lens_d, cov_d, tp), fvars[1:])
    del fvars
    fseqs, fquals = feed_edge_reads(np.random.default_rng(SEED + 1000))
    fc_np, _, fl_np, _ = eg.encode_two_half(fseqs, fquals)
    feed_set = {}
    for n in (1, 37, len(fseqs)):
        for tag, ix in (("cov", covered_index(fl_np[:n], tp, "cpu")),
                        ("all", torch.arange(n, dtype=torch.int32))):
            got = ts.tile_feed(torch.from_numpy(fc_np[:n]).to(dev),
                               torch.from_numpy(fl_np[:n]).to(dev),
                               ix.to(dev), tp)
            ref = ts.tile_feed_plain(torch.from_numpy(fc_np[:n]),
                                     torch.from_numpy(fl_np[:n]), ix, tp)
            feed_set[f"b{n}_{tag}"] = int((got.cpu() != ref).sum()) \
                if got.shape == ref.shape else got.numel() + 1
    buf = torch.zeros(2 * 2 * eg.E + 16, dtype=torch.int8, device=dev)
    try:
        ts.tile_feed(buf[1:1 + 2 * 2 * eg.E].view(2, -1),
                     torch.zeros(2, dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev), tp)
        unaligned_raises = False
    except ValueError:
        unaligned_raises = True
    results["tilefeed_edge_cases"] = {
        "mismatches": sum(feed_set.values()) + (not unaligned_raises),
        "cases": feed_set, "reads": len(fseqs),
        "unaligned_raises": unaligned_raises}
    frows = ts.tile_feed(codes, lens_d, cov_d, tp)
    svars = [frows] + [mutate_tiles(frows) for _ in range(TIMED_CALLS)]
    words_f, sites_f, bytes_f = tile_scan_work(frows, tp)
    results["tilescan_fed"] = compare(
        "tilescan_fed", lambda r: ts.tile_scan(r, tp),
        lambda r: ts.tile_scan_plain(r, tp), svars)
    results["tilescan_fed"].update(bound(
        bytes_f + 3 * n_cov * 4,
        words_f * TILE_WORD_OPS + sites_f * ts.WI_CONFIRM * MYERS_OPS,
        int32_hz))
    results["tilescan_fed"].update({"tiles": n_cov, "words": words_f,
                                    "sites": sites_f})
    results["tilescan_fed"]["device_ms"] = device_ms(
        lambda r: ts.tile_scan(r, tp), svars[1:])
    results["tilescan_fed"]["burst_ms"] = burst_ms(
        lambda r: ts.tile_scan(r, tp), svars[1:])
    del svars, frows

    # the window search at the shapes its paths give it: the 5p composed
    # edge body's three searches over one chunk, the confirm windows of
    # the chunk's tiles
    head5, tail5 = codes5[:, :eg.E], codes5[:, eg.E:]
    hl5 = lens5_d.clamp(max=eg.E)
    el5 = torch.full_like(lens5_d, eg.E)
    w_ad = torch.cat([
        readscan.gather_window(head5, hl5, torch.zeros_like(hl5), ep5.awin),
        readscan.gather_window(tail5, el5, el5 - ep5.awin, ep5.awin,
                               rc=True)])
    tso_start = torch.full_like(hl5, ep5.m_ad + ep5.bc_len)
    w_tso = readscan.gather_window(head5, hl5, tso_start, ep5.twin)
    tcodes = ts._unpack(rows_d)[0]
    w_conf = tcodes[:, :5 * 140 + ts.WI_CONFIRM].unfold(
        1, ts.WI_CONFIRM, 140).reshape(-1, ts.WI_CONFIRM).contiguous()
    w_conf[::9, 100:] = dna.PAD           # windows running off their tile
    w_conf[5] = dna.PAD                   # an all-PAD row
    tp_adc = tp.peq_adc

    def mutate_rows(w):
        """One substituted code per window row (fresh content)."""
        w = w.clone()
        n = w.shape[0]
        c = torch.randint(0, w.shape[1], (n,), device=dev, generator=g)
        w[torch.arange(n, device=dev), c] = torch.randint(
            0, 4, (n,), device=dev, generator=g, dtype=torch.int8)
        return w

    win1_shapes = {
        "win1": (w_ad, ep5.peq_ad, ep5.m_ad),
        "win1_adc": (w_ad[:B].contiguous(), ep5.peq_adc, ep5.m_adc),
        "win1_tso": (w_tso, ep5.peq_tso, ep5.m_tso),
        "win1_confirm": (w_conf, tp_adc, tp.m_adc),
        "win1_b37": (torch.cat([w_ad[:36], torch.full_like(w_ad[:1],
                                                           dna.PAD)]),
                     ep5.peq_ad, ep5.m_ad),
        "win1_b1": (w_tso[7:8].contiguous(), ep5.peq_tso, ep5.m_tso),
    }
    for key, (w, peq1, m1) in win1_shapes.items():
        results[key] = compare(
            key, lambda x: editdist.myers_win1(x, peq1, m1),
            lambda x: editdist.myers_win1_plain(x, peq1, m1),
            [w] + [mutate_rows(w) for _ in range(TIMED_CALLS)])
        nw, ww = w.shape
        results[key].update(bound(nw * ww + 2 * nw * 4,
                                  nw * ww * MYERS_OPS, int32_hz))
        results[key].update({"windows": nw, "columns": ww, "m": m1})
        wv = [mutate_rows(w) for _ in range(TIMED_CALLS)]
        results[key]["device_ms"] = device_ms(
            lambda x: editdist.myers_win1(x, peq1, m1), wv)
        results[key]["burst_ms"] = burst_ms(
            lambda x: editdist.myers_win1(x, peq1, m1), wv)
        del wv
    # rows whose data starts anywhere modulo 16 (the kernel stages a
    # block's span with 16-byte loads), and a window wider than one round
    w1_edges = {}
    for Be, We, me, off in WIN1_EDGE_SHAPES:
        a, pat = win1_edge_windows(Be, We, me, off)
        peq_e = editdist.build_peq(pat[None, :])
        got = editdist.myers_win1(unaligned_rows(a, off, dev), peq_e, me)
        ref = editdist.myers_win1_plain(torch.from_numpy(a), peq_e, me)
        w1_edges[f"{Be}x{We}_m{me}_off{off}"] = sum(
            int((x.cpu() != y).sum()) for x, y in zip(got, ref))
    results["win1_edge_cases"] = {"mismatches": sum(w1_edges.values()),
                                  "cases": w1_edges}
    host_us = wrapper_host_us(dev)
    ed_pad, pos_pad = editdist.myers_win1(win1_shapes["win1_b37"][0],
                                          ep5.peq_ad, ep5.m_ad)
    if (int(ed_pad[36]), int(pos_pad[36])) != (ep5.m_ad, -1):
        raise SystemExit("win1: an all-PAD row must report (m, -1)")

    # the composed edge body (torch ops + three window searches; the route
    # of configs outside the fused kernel's envelope) on the 5p chunk,
    # beside the fused kernel's edgescan_5p on the same reads
    results["edge_composed_5p"] = compare(
        "edge_composed_5p",
        lambda c: eg.edge_scan2_composed(c[:, :eg.E], c[:, eg.E:], lens5_d,
                                         ep5),
        lambda c: eg.edge_scan2_plain(c[:, :eg.E], c[:, eg.E:], lens5_d,
                                      ep5),
        [codes5, codes5.clone()])
    results["edge_composed_5p"]["split_ms"] = composed_split(
        codes5, lens5_d, ep5)
    del wvars, rows_d, meta, wins, codes, tcodes
    del win1_shapes, w_ad, w_tso, w_conf, codes5, head5, tail5
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 100)
    for Lc, W, n_pairs, lo, hi in BAND_SHAPES:
        reads_d, rl_d, mids_d, cmol_d, clm_d = band_pairs(
            rng, Lc, W, n_pairs, lo, hi, dev)
        P = reads_d.shape[0]
        ar = torch.arange(P, device=dev)

        def mutate_pairs(r):
            """One substituted base per read, inside the read."""
            r = r.clone()
            col = (torch.rand(P, device=dev, generator=g)
                   * rl_d.clamp(min=1)).long()
            r[ar, col] = torch.where(
                rl_d > 0, torch.randint(0, 4, (P,), device=dev, generator=g,
                                        dtype=torch.int8), r[ar, col])
            return r

        key = f"bandalign_{Lc}_{W}"
        bvars = [reads_d] + [mutate_pairs(reads_d)
                             for _ in range(TIMED_CALLS)]
        results[key] = compare(
            key,
            lambda r: poa_cuda.band_align(r, rl_d, mids_d, cmol_d, clm_d,
                                          Lc, W),
            lambda r: poa_cuda.band_align_plain(r, rl_d, mids_d, cmol_d,
                                                clm_d, Lc, W),
            bvars)
        band_cells = int(clm_d[mids_d.long()].sum()) * W
        results[key].update(bound(
            nbytes(reads_d, rl_d, mids_d, cmol_d, clm_d)
            + P * (Lc + 1) * (1 + 4 * poa_cuda.K_INS) + 4 * P,
            band_cells * BAND_CELL_OPS, int32_hz))
        results[key].update({"pairs": P, "band_cells": band_cells})
        results[key]["device_ms"] = device_ms(
            lambda r: poa_cuda.band_align(r, rl_d, mids_d, cmol_d, clm_d,
                                          Lc, W), bvars[1:])
        results[key]["burst_ms"] = burst_ms(
            lambda r: poa_cuda.band_align(r, rl_d, mids_d, cmol_d, clm_d,
                                          Lc, W), bvars[1:])
        del reads_d, rl_d, mids_d, cmol_d, clm_d, bvars
        torch.cuda.empty_cache()
    # the aligner's gap buckets (Lc 64-256, W 32): pairs as GapBatcher
    # builds them, each its own molecule
    from sicelore_tpu_torch.align import extend
    gb = extend.GapBatcher(dev)
    for Lc, n_pairs in GAP_SHAPES:
        W = poa_cuda.w_for(Lc)
        pairs = gap_pairs(np.random.default_rng(SEED + 800 + Lc), Lc,
                          n_pairs)
        reads_d, rl_d, cmol_d, clm_d = gb._build_bucket(pairs, Lc, W)
        P = reads_d.shape[0]
        mids_d = torch.arange(P, dtype=torch.int32, device=dev)
        ar = torch.arange(P, device=dev)

        def mutate_gaps(r):
            """One substituted base per read, inside the read."""
            r = r.clone()
            col = (torch.rand(P, device=dev, generator=g)
                   * rl_d.clamp(min=1)).long()
            r[ar, col] = torch.where(
                rl_d > 0, torch.randint(0, 4, (P,), device=dev, generator=g,
                                        dtype=torch.int8), r[ar, col])
            return r

        def gap_call(r):
            return poa_cuda.band_align(r, rl_d, mids_d, cmol_d, clm_d, Lc, W)

        key = f"bandalign_gap_{Lc}_{W}"
        gvars = [reads_d] + [mutate_gaps(reads_d)
                             for _ in range(TIMED_CALLS)]
        results[key] = compare(
            key, gap_call,
            lambda r: poa_cuda.band_align_plain(r, rl_d, mids_d, cmol_d,
                                                clm_d, Lc, W), gvars)
        band_cells = int(clm_d.sum()) * W
        results[key].update(bound(
            nbytes(reads_d, rl_d, mids_d, cmol_d, clm_d)
            + P * (Lc + 1) * (1 + 4 * poa_cuda.K_INS) + 4 * P,
            band_cells * BAND_CELL_OPS, int32_hz))
        feas = gap_call(reads_d)[2]
        results[key].update({
            "pairs": P, "band_cells": band_cells,
            "feasible": int(feas.sum()),
            "device_ms": device_ms(gap_call, gvars[1:]),
            "burst_ms": burst_ms(gap_call, gvars[1:])})
        del reads_d, rl_d, mids_d, cmol_d, clm_d, gvars
    # the UMI distance matrix kernel at the groups assignumis gives it: the
    # timing group (256 UMIs of 12 nt and 32 of 16 nt), one of mixed
    # lengths with N, an empty and a 33-nt UMI (host rows), one of 3,000
    results.update(pairwise_phase(dev, int32_hz))
    # the host engine's alignment at a wta- and a deep-like call's pairs
    results.update(hostnw_phase(dev, int32_hz))
    # pairs the regrouped kernel could get wrong: P not a multiple of the
    # pairs a warp holds, infeasible pairs, paths along the band's edge,
    # empty reads, a center of length 0
    band_edges = {}
    for n_pairs, length, Lc, W in BAND_EDGE_SHAPES:
        args = band_edge_pairs(rng, n_pairs, length, Lc, W, dev)
        ref = poa_cuda.band_align_plain(*args, Lc, W)
        got = poa_cuda.band_align(*args, Lc, W)
        bad = sum(int((a != b).sum()) for a, b in zip(got, ref))
        n_feas = int(ref[2].sum())
        if n_pairs > 30 and not 0 < n_feas < n_pairs:
            raise SystemExit(f"band edge pairs {n_pairs}/{Lc}/{W}: "
                             f"{n_feas} feasible, want some and not all")
        band_edges[f"{n_pairs}_{Lc}_{W}"] = {"mismatches": bad,
                                             "feasible": n_feas}
    results["bandalign_edge_cases"] = {
        "mismatches": sum(v["mismatches"] for v in band_edges.values()),
        "cases": band_edges}
    emit({"phase": "kernels", "reads": B, "tiles": n_tiles,
          "tolerance": "exact", "wrapper_host_us": host_us,
          "results": results,
          "s": round(time.time() - t0, 2)})
    bad = {k: v["mismatches"] for k, v in results.items() if v["mismatches"]}
    if bad:
        raise SystemExit(f"kernel/plain mismatches: {bad}")
    over = {k: v["bound_ms"] / t for k, v in results.items()
            for t in (v.get("device_ms"), v.get("burst_ms"))
            if t and v.get("bound_ms") and v["bound_ms"] > t}
    if over:
        raise SystemExit(f"a kernel beat its bound (a fault of the "
                         f"measurement): {over}")
    if "--kernels-only" in sys.argv[1:]:
        return 0        # a kernel's author iterating: no path, no ok line

    # ---- the main path: scanfastq on cuda ----
    counters = (enc.encode_two_half_dev, enc.encode_composite_dev,
                edge_scan2, bcsearch.bc_sweep, ts.tile_feed, ts.tile_scan,
                editdist.myers_win1, eg.edge_scan2_composed,
                enc.encode_two_half_plain, enc.encode_composite_plain,
                eg.edge_scan2_plain, bcsearch.bc_sweep_plain,
                ts.tile_feed_plain, ts.tile_scan_plain,
                editdist.myers_win1_plain)

    def zero_counts():
        for c in counters:
            c.launches = 0
        edge_scan2.launches_5p = 0

    def read_counts():
        return ({"encode_two_half": enc.encode_two_half_dev.launches,
                 "encode_composite": enc.encode_composite_dev.launches,
                 "edgescan": edge_scan2.launches,
                 "edgescan_5p": edge_scan2.launches_5p,
                 "bcsweep": bcsearch.bc_sweep.launches,
                 "tilefeed": ts.tile_feed.launches,
                 "tilescan": ts.tile_scan.launches,
                 "win1": editdist.myers_win1.launches,
                 "edge_composed": eg.edge_scan2_composed.launches},
                {"encode_two_half": enc.encode_two_half_plain.launches,
                 "encode_composite": enc.encode_composite_plain.launches,
                 "edgescan": eg.edge_scan2_plain.launches,
                 "bcsweep": bcsearch.bc_sweep_plain.launches,
                 "tilefeed": ts.tile_feed_plain.launches,
                 "tilescan": ts.tile_scan_plain.launches,
                 "win1": editdist.myers_win1_plain.launches})

    t0 = time.time()
    pipe = ScanFastqPipeline(cfg, whitelist=wl, chunk_size=READS_PER_FILE,
                             user_max_ed=2, cache_pass1=True, device="cuda")
    zero_counts()
    t_run = time.time()
    stats = pipe.run([work / "run"], work / "out_cuda")
    torch.cuda.synchronize()
    run_s = time.time() - t_run
    launches, plain = read_counts()
    launches3 = dict(launches)
    total = N_FILES * READS_PER_FILE
    emit({"phase": "pipeline", "reads": stats.total_reads,
          "used_list": len(pipe.used_strs), "run_s": round(run_s, 3),
          "reads_per_s": round(total / run_s, 1), "stats": stats.to_json(),
          "launches": launches, "plain_launches": plain,
          **fused_split(launches), "s": round(time.time() - t0, 2)})
    if (min(launches[k] for k in ("encode_two_half", "edgescan", "bcsweep",
                                  "tilefeed", "tilescan")) < 1
            or launches["win1"] or launches["edge_composed"]
            or launches["edgescan_5p"] or any(plain.values())):
        raise SystemExit(f"main path launches {launches}, plain {plain}")
    if (stats.total_reads != total or stats.stranded < 0.8 * total
            or stats.bc_assigned < 0.6 * total
            or stats.split_chimeric < 1):
        raise SystemExit(f"implausible scan stats: {stats.to_json()}")

    # ---- parity: cuda vs cpu (plain bodies) on a subset ----
    t0 = time.time()
    head = write_subset(work / "run" / "reads0.fastq",
                        work / "parity_in" / "subset.fastq", N_PARITY)
    n_files, _, out_cuda, pl_ln = cuda_cpu_outputs(
        lambda d: ScanFastqPipeline(cfg, whitelist=wl, chunk_size=1024,
                                    user_max_ed=2, cache_pass1=True,
                                    device=d),
        [work / "parity_in"], work, "parity")
    n_ok, n_tot = bc_truth(out_cuda / "passed", cells)
    emit({"phase": "parity", "reads": len(head), "files": n_files,
          "identical": n_files, "bc_truth_agree": n_ok, "bc_checked": n_tot,
          "launches": pl_ln, **fused_split(pl_ln["cuda"]),
          "s": round(time.time() - t0, 2)})
    if n_tot < 1000 or n_ok < 0.97 * n_tot:
        raise SystemExit(f"barcode truth agreement {n_ok}/{n_tot}")
    check_fused_parity("parity", pl_ln)

    # ---- the third main path: 5p scanfastq on cuda (composed edge body) ----
    t0 = time.time()
    pipe5 = ScanFastqPipeline(cfg5, whitelist=wl, chunk_size=READS_PER_FILE,
                              user_max_ed=2, cache_pass1=True, device="cuda")
    zero_counts()
    t_run = time.time()
    stats5 = pipe5.run([work / "run5p"], work / "out5p_cuda")
    torch.cuda.synchronize()
    run5_s = time.time() - t_run
    launches5, plain5 = read_counts()
    emit({"phase": "pipeline_5p", "reads": stats5.total_reads,
          "used_list": len(pipe5.used_strs), "run_s": round(run5_s, 3),
          "reads_per_s": round(total / run5_s, 1),
          "assigned_share": round(stats5.bc_assigned / total, 4),
          "stats": stats5.to_json(), "launches": launches5,
          "plain_launches": plain5, **fused_split(launches5),
          "s": round(time.time() - t0, 2)})
    if (min(launches5[k] for k in ("encode_two_half", "edgescan",
                                   "bcsweep", "tilefeed", "tilescan")) < 1
            or launches5["win1"] or launches5["edge_composed"]
            or launches5["edgescan_5p"] != launches5["edgescan"]
            or any(plain5.values())):
        raise SystemExit(f"5p path launches {launches5}, plain {plain5}")
    if (stats5.total_reads != total or stats5.stranded < 0.8 * total
            or stats5.bc_assigned < 0.6 * total):
        raise SystemExit(f"implausible 5p scan stats: {stats5.to_json()}")

    t0 = time.time()
    head = write_subset(work / "run5p" / "reads0.fastq",
                        work / "parity5p_in" / "subset.fastq", N_PARITY)
    n_files, _, out_cuda, pl_ln = cuda_cpu_outputs(
        lambda d: ScanFastqPipeline(cfg5, whitelist=wl, chunk_size=1024,
                                    user_max_ed=2, cache_pass1=True,
                                    device=d),
        [work / "parity5p_in"], work, "parity5p")
    n_ok, n_tot = bc_truth(out_cuda / "passed", cells)
    emit({"phase": "parity_5p", "reads": len(head), "files": n_files,
          "identical": n_files, "bc_truth_agree": n_ok, "bc_checked": n_tot,
          "launches": pl_ln, **fused_split(pl_ln["cuda"]),
          "s": round(time.time() - t0, 2)})
    if n_tot < 1000 or n_ok < 0.97 * n_tot:
        raise SystemExit(f"5p barcode truth agreement {n_ok}/{n_tot}")
    check_fused_parity("parity_5p", pl_ln)

    # ---- the fourth main path: the random-barcode control (synchronous
    # pass 2: split_chimeras, scan_reads, bc_search) on cuda ----
    t0 = time.time()

    def control(d, size):
        return ScanFastqPipeline(cfg, whitelist=wl, chunk_size=size,
                                 user_max_ed=CONTROL_MAX_ED,
                                 random_barcode=True, seed=CONTROL_SEED,
                                 device=d)

    pipe_c = control("cuda", READS_PER_FILE)
    zero_counts()
    t_run = time.time()
    stats_c = pipe_c.run([work / "run" / "reads0.fastq"],
                         work / "control_cuda")
    torch.cuda.synchronize()
    ctl_s = time.time() - t_run
    launches_c, plain_c = read_counts()
    false_share = stats_c.bc_assigned / max(stats_c.stranded, 1)
    n_files, _, _, _ = cuda_cpu_outputs(lambda d: control(d, 1024),
                                     [work / "parity_in"], work,
                                     "control_parity")
    emit({"phase": "v1_control", "reads": stats_c.total_reads,
          "used_list": len(pipe_c.used_strs), "max_ed": CONTROL_MAX_ED,
          "seed": CONTROL_SEED, "run_s": round(ctl_s, 3),
          "reads_per_s": round(stats_c.total_reads / ctl_s, 1),
          "falsely_assigned_share": false_share,
          "normal_run_assigned_share": stats.bc_assigned / stats.stranded,
          "normal_run_max_ed": 2, "stats": stats_c.to_json(),
          "launches": launches_c, "plain_launches": plain_c,
          "parity_reads": N_PARITY, "parity_files_identical": n_files,
          "s": round(time.time() - t0, 2)})
    if (min(launches_c[k] for k in ("encode_two_half", "encode_composite",
                                    "win1", "edgescan", "bcsweep",
                                    "tilescan")) < 1
            or launches_c["edge_composed"] or any(plain_c.values())):
        raise SystemExit(f"control launches {launches_c}, plain {plain_c}")
    if (stats_c.total_reads != READS_PER_FILE
            or stats_c.stranded < 0.8 * READS_PER_FILE
            or stats_c.split_chimeric < 1 or not false_share < 0.05):
        raise SystemExit(f"control: falsely assigned share {false_share}, "
                         f"stats {stats_c.to_json()}")

    # where the three runs' time goes: each once more with a timer (and a
    # device sync) around every stage
    t0 = time.time()
    splits = {}
    for tag, make, inputs, first in (
            ("3p", lambda: ScanFastqPipeline(
                cfg, whitelist=wl, chunk_size=READS_PER_FILE, user_max_ed=2,
                cache_pass1=True, device="cuda"), [work / "run"], stats),
            ("5p", lambda: ScanFastqPipeline(
                cfg5, whitelist=wl, chunk_size=READS_PER_FILE, user_max_ed=2,
                cache_pass1=True, device="cuda"), [work / "run5p"], stats5),
            ("control", lambda: control("cuda", READS_PER_FILE),
             [work / "run" / "reads0.fastq"], stats_c)):
        splits[tag] = scanfastq_split(make(), inputs, work / f"split_{tag}")
        if splits[tag].pop("stats") != first.to_json():
            raise SystemExit(f"instrumented {tag} run differs from the first")
        splits[tag] = splits[tag]["seconds"]
    emit({"phase": "scanfastq_split", "seconds": splits,
          "s": round(time.time() - t0, 2)})

    # the empty-used-list branch: a whitelist that shares no barcode with
    # the reads, so pass 1 finds nothing and pass 2 is pass2_chunk
    t0 = time.time()
    other = [w for w in synth.make_whitelist(
        np.random.default_rng(SEED + 400), 64) if w not in set(wl)]
    zero_counts()
    n_files, pipe_e, _, _ = cuda_cpu_outputs(
        lambda d: ScanFastqPipeline(cfg, whitelist=other, chunk_size=1024,
                                    user_max_ed=2, device=d),
        [work / "parity_in"], work, "empty_list")
    launches_e, _ = read_counts()
    emit({"phase": "empty_used_list", "reads": pipe_e.stats.total_reads,
          "used_list": len(pipe_e.used_strs),
          "bc_assigned": pipe_e.stats.bc_assigned,
          "stranded": pipe_e.stats.stranded, "launches": launches_e,
          "files_identical": n_files, "s": round(time.time() - t0, 2)})
    if (pipe_e.used_peq is not None or pipe_e.stats.bc_assigned
            or pipe_e.stats.total_reads != N_PARITY
            or pipe_e.stats.stranded < 0.8 * N_PARITY
            or launches_e["win1"] < 3 or launches_e["bcsweep"]):
        raise SystemExit(f"empty used list: {pipe_e.stats.to_json()}, "
                         f"launches {launches_e}")

    # the q-gram prefilter mode against the brute sweep mode, both fused
    # with the edge scan on the card, over the parity subset and the 3p
    # run's used list
    t0 = time.time()
    head = next(fastq.read_fastq(work / "parity_in" / "subset.fastq",
                                 N_PARITY))
    found = {}
    for mode in ("sweep", "prefilter"):
        model = readscan.ReadScanModel(cfg, device="cuda")
        model.prepare_search(pipe.used_pats, len(pipe.used_strs),
                             radius=PREFILTER_RADIUS, mode=mode)
        found[mode] = model.finish_search(
            model.scan_search_async(head.seqs, head.quals))[1]
    near = found["sweep"]["ed"] <= PREFILTER_RADIUS
    pre_bad = int((found["prefilter"]["ed"][near]
                   != found["sweep"]["ed"][near]).sum()
                  + (found["prefilter"]["idx"][near]
                     != found["sweep"]["idx"][near]).sum()
                  + (found["prefilter"]["ed"][~near] != bcsearch.BIG).sum())
    emit({"phase": "prefilter", "reads": len(head),
          "used_list": len(pipe.used_strs), "radius": PREFILTER_RADIUS,
          "within_radius": int(near.sum()), "mismatches": pre_bad,
          "s": round(time.time() - t0, 2)})
    if pre_bad or near.sum() < 0.5 * len(head):
        raise SystemExit(f"prefilter vs sweep: {pre_bad} mismatches, "
                         f"{int(near.sum())} reads within the radius")

    # ---- the second main path: computeconsensus on cuda ----
    t0 = time.time()
    rng = np.random.default_rng(SEED + 200)
    mols, truths = consensus_molecules(rng, N_MOLECULES)
    keys = write_bam(work / "cons.bam", mols, rng, "m")
    gen_s = time.time() - t0
    cons_counters = (poa_cuda.band_align, poa_cuda.band_align_plain,
                     hostnw_cuda.host_nw, hostnw_cuda.host_nw_plain)
    for c in cons_counters:
        c.launches = 0
    t_run = time.time()
    cstats = compute_consensus(work / "cons.bam", work / "cons_cuda.fastq",
                               device="cuda",
                               log_json=work / "cons_cuda.fastq.log")
    torch.cuda.synchronize()
    cons_s = time.time() - t_run
    launches["bandalign"] = poa_cuda.band_align.launches
    launches["hostnw"] = hostnw_cuda.host_nw.launches
    cons_plain = {"band_align_plain": poa_cuda.band_align_plain.launches,
                  "host_nw_plain": hostnw_cuda.host_nw_plain.launches}
    recs = read_fastq_records(work / "cons_cuda.fastq")
    multi = [r for r in recs if len(mols[keys[r[0].rsplit("-", 1)[0]]]) > 2
             and len(truths[keys[r[0].rsplit("-", 1)[0]]]) <= 2048]
    worst, n_far = 0.0, 0
    for name, cons, qv in multi[::max(1, len(multi) // 256)]:
        truth = truths[keys[name.rsplit("-", 1)[0]]]
        if len(cons) != len(qv):
            raise SystemExit(f"{name}: {len(cons)} bases, {len(qv)} QVs")
        d = levenshtein(cons, truth) / len(truth)
        worst = max(worst, d)
        n_far += d > 0.02
    emit({"phase": "consensus", "molecules": cstats["molecules"],
          "written": cstats["written"], "records": cstats["total_records"],
          "multi_read": len(multi), "run_s": round(cons_s, 3),
          "umis_per_s": round(N_MOLECULES / cons_s, 1),
          "launches": {"bandalign": launches["bandalign"],
                       "hostnw": launches["hostnw"]},
          "plain_launches": cons_plain, "worst_truth_distance": worst,
          "data_s": round(gen_s, 2), "s": round(time.time() - t0, 2)})
    if (launches["bandalign"] < 1 or launches["hostnw"] < 1
            or any(cons_plain.values())):
        raise SystemExit(f"consensus launches {launches['bandalign']} "
                         f"bandalign, {launches['hostnw']} hostnw, plain "
                         f"{cons_plain}")
    if (cstats["molecules"] != N_MOLECULES or cstats["written"] != N_MOLECULES
            or len(recs) != N_MOLECULES or n_far):
        raise SystemExit(f"consensus: {cstats}, {n_far} sampled consensuses "
                         f"beyond 2% of their truth (worst {worst:.4f})")

    # where the phase's time goes: the same run again with a timer (and a
    # device sync) around each stage
    t0 = time.time()
    cons_split = consensus_split(work / "cons.bam",
                                 work / "cons_split.fastq")
    emit({"phase": "consensus_split", "seconds": cons_split,
          "s": round(time.time() - t0, 2)})
    if (work / "cons_split.fastq").read_bytes() != \
            (work / "cons_cuda.fastq").read_bytes():
        raise SystemExit("instrumented consensus run differs from the first")

    # ---- consensus parity: cuda vs cpu on a subset ----
    t0 = time.time()
    write_bam(work / "cons_sub.bam", mols[-N_CONS_PARITY:], rng, "s")
    blobs = {}
    for d in ("cuda", "cpu"):
        out = work / f"cons_sub_{d}.fastq"
        compute_consensus(work / "cons_sub.bam", out, device=d,
                          log_json=str(out) + ".log")
        blobs[d] = (out.read_bytes(), Path(str(out) + ".log").read_bytes())
    emit({"phase": "consensus_parity", "molecules": N_CONS_PARITY,
          "fastq_bytes": len(blobs["cuda"][0]),
          "identical": blobs["cuda"] == blobs["cpu"],
          "s": round(time.time() - t0, 2)})
    if blobs["cuda"] != blobs["cpu"] or not blobs["cuda"][0]:
        raise SystemExit("cuda/cpu consensus outputs differ")

    # ---- mesh: the 3p scan and the consensus split across a mesh (two
    # shards on the one card, or one a card where there are more) ----
    t0 = time.time()
    from sicelore_tpu_torch.parallel import shard
    n_cards = torch.cuda.device_count()
    mesh = ([f"cuda:{i}" for i in range(n_cards)] if n_cards > 1
            else ["cuda:0", "cuda:0"])
    with ShardLaunches() as scan_shards:
        pipe_m = ScanFastqPipeline(cfg, whitelist=wl,
                                   chunk_size=READS_PER_FILE, user_max_ed=2,
                                   cache_pass1=True, device="cuda", mesh=mesh)
        zero_counts()
        t_run = time.time()
        stats_m = pipe_m.run([work / "run"], work / "out_mesh")
        torch.cuda.synchronize()
        mesh_s = time.time() - t_run
        launches_m, plain_m = read_counts()
    with ShardLaunches() as cons_shards:
        for c in cons_counters:
            c.launches = 0
        t_run = time.time()
        cstats_m = compute_consensus(
            work / "cons.bam", work / "cons_mesh.fastq",
            engine=poa_cuda.BatchedConsensusEngine(mesh=mesh),
            log_json=work / "cons_mesh.fastq.log")
        torch.cuda.synchronize()
        cons_mesh_s = time.time() - t_run
        launches_m["bandalign"] = poa_cuda.band_align.launches
        launches_m["hostnw"] = hostnw_cuda.host_nw.launches
        plain_m["bandalign"] = poa_cuda.band_align_plain.launches
        plain_m["hostnw"] = hostnw_cuda.host_nw_plain.launches
    mesh_files = output_files(work / "out_mesh", skip=())
    one_files = output_files(work / "out_cuda", skip=())
    scan_differ = sorted(k for k in set(mesh_files) | set(one_files)
                         if mesh_files.get(k) != one_files.get(k))
    cons_same = all((work / f"cons_mesh{x}").read_bytes()
                    == (work / f"cons_cuda{x}").read_bytes()
                    for x in (".fastq", ".fastq.log"))
    mesh_kernels = ("encode_two_half", "edgescan", "bcsweep", "tilescan")
    mesh_ph = {
        "phase": "mesh", "mesh": mesh, "shards": len(mesh),
        "cards": n_cards, "reads": stats_m.total_reads,
        "run_s": round(mesh_s, 3),
        "reads_per_s": round(total / mesh_s, 1),
        "single_reads_per_s": round(total / run_s, 1),
        "files": len(mesh_files), "files_differ": scan_differ,
        "molecules": cstats_m["molecules"],
        "consensus_run_s": round(cons_mesh_s, 3),
        "umis_per_s": round(N_MOLECULES / cons_mesh_s, 1),
        "single_umis_per_s": round(N_MOLECULES / cons_s, 1),
        "consensus_identical": cons_same,
        "launches": launches_m, "plain_launches": plain_m,
        "scan_launches_per_shard": scan_shards.per_shard,
        "consensus_launches_per_shard": cons_shards.per_shard,
        "s": round(time.time() - t0, 2)}
    emit(mesh_ph)
    if scan_differ or not cons_same:
        raise SystemExit(f"mesh outputs differ from one device: scan "
                         f"{scan_differ}, consensus identical {cons_same}")
    if (len(scan_shards.per_shard) != len(mesh)
            or len(cons_shards.per_shard) != len(mesh)
            or min(sh.get(k, 0) for sh in scan_shards.per_shard
                   for k in mesh_kernels) < 1
            or min(sh.get("bandalign", 0)
                   for sh in cons_shards.per_shard) < 1
            or launches_m["win1"] or launches_m["edge_composed"]
            or launches_m["tilefeed"] or any(plain_m.values())
            or any(k.startswith("plain_") for sh in scan_shards.per_shard
                   + cons_shards.per_shard for k in sh)):
        raise SystemExit(f"mesh launches {launches_m}, plain {plain_m}, per "
                         f"shard {scan_shards.per_shard} "
                         f"{cons_shards.per_shard}")

    # ---- multiprocess: the 3p scan in two processes (gloo) on the card,
    # each on files[rank::2] ----
    t0 = time.time()
    ranks, mp_wall = multiprocess_run(work / "run", work / "out_mp", wl)
    single = output_files(work / "out_cuda", skip=("ReadScanner.html",
                                                   "BarcodesAssigned.tsv",
                                                   "scanner_stats.json"))
    got = output_files(work / "out_mp", skip=("ReadScanner.html",
                                              "BarcodesAssigned.tsv",
                                              "scanner_stats.json"))
    mp_differ = sorted(k for k in set(single) | set(got)
                       if single.get(k) != got.get(k))
    # the merged BarcodesAssigned.tsv holds tied barcodes in used-list
    # order, as the JAX pipeline's merge does; one process holds them in
    # the order of their first assignment
    ba_want = work / "mp_BarcodesAssigned.tsv"
    ScanFastqPipeline.write_barcodes_assigned(
        SimpleNamespace(assigned_hist=dict(sorted(pipe.assigned_hist.items())),
                    used_strs=pipe.used_strs), ba_want)
    ba_got = (work / "out_mp" / "BarcodesAssigned.tsv").read_bytes()
    ba_ok = ba_got == ba_want.read_bytes()
    stats_ok = (json.loads((work / "out_mp" / "scanner_stats.json")
                           .read_text())
                == json.loads(json.dumps(stats.to_json()))
                == ranks[0]["stats"] == ranks[1]["stats"])
    mp_ph = {
        "phase": "multiprocess", "processes": len(ranks),
        "files_per_rank": [sorted(p.name for p in (work / "run").glob(
            "*.fastq"))[r::len(ranks)] for r in range(len(ranks))],
        "run_s": [round(r["run_s"], 3) for r in ranks],
        "wall_s": round(mp_wall, 3),
        "reads_per_s": round(total / max(r["run_s"] for r in ranks), 1),
        "single_reads_per_s": round(total / run_s, 1),
        "files": len(got) + 2, "files_differ": mp_differ,
        "barcodes_assigned_merge_order": ba_ok,
        "barcodes_assigned_as_one_process":
            ba_got == (work / "out_cuda" / "BarcodesAssigned.tsv")
            .read_bytes(),
        "stats_merged": stats_ok,
        "used_lists_equal": all(r["used"] == pipe.used_strs for r in ranks),
        "launches_per_rank": [r["launches"] for r in ranks],
        "s": round(time.time() - t0, 2)}
    emit(mp_ph)
    if (mp_differ or not ba_ok or not stats_ok
            or not mp_ph["used_lists_equal"] or any(r["jax"] for r in ranks)
            or [r["rank"] for r in ranks] != list(range(len(ranks)))):
        raise SystemExit(f"multiprocess outputs differ: {mp_differ}, "
                         f"BarcodesAssigned {ba_ok}, stats {stats_ok}")
    if any(min(r["launches"].get(k, 0)
               for k in mesh_kernels + ("tilefeed",)) < 1
           or r["launches"]["edgescan_5p"]
           or any(k.startswith("plain_") or k in ("win1", "edge_composed")
                  for k in r["launches"]) for r in ranks):
        raise SystemExit(f"multiprocess launches "
                         f"{[r['launches'] for r in ranks]}")

    # ---- Steps 1 -> 2 -> 3 -> 4b on cuda: fastq to consensus ----
    t0 = time.time()
    from sicelore_tpu_torch.align import aligner as aln_mod
    from sicelore_tpu_torch.core import umicluster
    from sicelore_tpu_torch.io import bam as bam_mod
    from sicelore_tpu_torch.pipeline import assignumis as umi_mod
    crng = np.random.default_rng(SEED + 1000)
    cwl = synth.make_whitelist(crng, CHAIN_WHITELIST)
    ccells = [cwl[i] for i in sorted(crng.choice(
        CHAIN_WHITELIST, CHAIN_CELLS, replace=False).tolist())]
    contigs, genes = chain_genome(crng, CHAIN_CONTIGS, CHAIN_CONTIG_LEN,
                                  CHAIN_GENES)
    cdir = work / "chain"
    (cdir / "fq").mkdir(parents=True)
    (cdir / "sub").mkdir()
    ref, refflat = cdir / "ref.fa", cdir / "ref.refflat"
    write_chain_refs(contigs, genes, ref, refflat)
    creads, group_gene = chain_reads(crng, contigs, genes, ccells,
                                     CHAIN_READS, CHAIN_BIG_GROUPS,
                                     big_mols=CHAIN_BIG_MOLECULES)
    write_reads(cdir / "fq" / "reads.fastq", creads)
    # the parity subset: the reads of the first large group, then of small
    # groups, up to CHAIN_PARITY reads
    keep, n_sub = {0}, sum(r[3] == 0 for r in creads)
    per_group = np.bincount([r[3] for r in creads])
    for gi in range(CHAIN_BIG_GROUPS, len(group_gene)):
        if n_sub + per_group[gi] > CHAIN_PARITY:
            break
        keep.add(gi)
        n_sub += int(per_group[gi])
    write_reads(cdir / "sub" / "reads.fastq",
                [r for r in creads if r[3] in keep])
    gen_s = time.time() - t0
    # the run itself carries the timers (a device sync around the device
    # parts): wrappers of methods without launch counters only
    secs, buckets, ed_calls = {}, [], []
    step = {"name": ""}

    def record_bucket(self, reads, rlens, cent, clens, Lc, W):
        buckets.append((Lc, int(reads.shape[0])))
        return inner_bucket(self, reads, rlens, cent, clens, Lc, W)

    def record_ed(umis, device="cuda"):
        ed_calls.append((str(device), len(umis)))
        return inner_ed(umis, device)

    undo = [timed_fn(secs, aln_mod.NativeAligner, "_plan", "align_planning"),
            timed_fn(secs, extend.GapBatcher, "_build_bucket",
                     "align_bucket_build"),
            timed_fn(secs, extend.GapBatcher, "_align_bucket",
                     "align_device", sync=True),
            timed_fn(secs, aln_mod.NativeAligner, "_finish_read",
                     "align_finish"),
            timed_fn(secs, aln_mod.NativeAligner, "_write_bam",
                     "align_bam_write"),
            timed_fn(secs, umi_mod, "cluster_group", "umi_clustering"),
            timed_fn(secs, umicluster, "_pairwise_ed_device",
                     "umi_device_ed", sync=True),
            timed_fn(secs, aln_mod.idx, "MinimizerIndex", "align_index"),
            timed_fn(secs, bam_mod.BamWriter, "write",
                     lambda: f"records_written_{step['name']}")]
    inner_bucket = extend.GapBatcher._align_bucket
    inner_ed = umicluster._pairwise_ed_device
    extend.GapBatcher._align_bucket = record_bucket
    umicluster._pairwise_ed_device = record_ed
    undo += [lambda: setattr(extend.GapBatcher, "_align_bucket",
                             inner_bucket),
             lambda: setattr(umicluster, "_pairwise_ed_device", inner_ed)]
    try:
        steps, _ = chain_steps("cuda", cdir / "fq", ref, refflat, cwl,
                               cdir / "run",
                               on_step=lambda n: step.update(name=n))
    finally:
        for u in reversed(undo):
            u()
    n_prim, n_map, n_ge = chain_truth(cdir / "run" / "aligned.bam",
                                      cdir / "run" / "umi.bam", genes)
    al, um = steps["align"], steps["assignumis"]
    umi_total = um["result"]["total_records"]
    split = {
        "align": {k: secs.get(f"align_{k}", 0.0) for k in (
            "index", "planning", "bucket_build", "device", "finish",
            "bam_write")},
        "assignumis": {"device_ed": secs.get("umi_device_ed", 0.0),
                       "clustering_host": secs.get("umi_clustering", 0.0)
                       - secs.get("umi_device_ed", 0.0),
                       "write": secs.get("records_written_assignumis",
                                         0.0)}}
    split["align"]["rest"] = al["s"] - sum(split["align"].values())
    split["assignumis"]["parse_tag_rest"] = um["s"] - (
        secs.get("umi_clustering", 0.0) + split["assignumis"]["write"])
    by_lc = {}
    for Lc, P in buckets:
        c = by_lc.setdefault(str(Lc), {"calls": 0, "pairs": 0})
        c["calls"] += 1
        c["pairs"] += P
    hostenc = native.get_hostenc()
    cons = steps["computeconsensus"]["result"]
    chain = {
        "phase": "steps_1_to_4b", "reads": CHAIN_READS,
        "genome_bases": CHAIN_CONTIGS * CHAIN_CONTIG_LEN,
        "genes": CHAIN_GENES, "cells": CHAIN_CELLS,
        "groups": len(group_gene), "large_groups": CHAIN_BIG_GROUPS,
        "step_s": {k: round(v["s"], 3) for k, v in steps.items()},
        "launches": {k: v["launches"] for k, v in steps.items()},
        "align_reads_per_s": round(al["result"]["reads"] / al["s"], 1),
        "assignumis_records_per_s": round(umi_total / um["s"], 1),
        "split_s": {k: {kk: round(vv, 3) for kk, vv in v.items()}
                    for k, v in split.items()},
        "gap_buckets": by_lc, "device_ed_calls": len(ed_calls),
        "device_ed_devices": sorted({d for d, _ in ed_calls}),
        "device_ed_max_umis": max((k for _, k in ed_calls), default=0),
        "hostenc_chain_dp": bool(hostenc and hasattr(hostenc, "chain_dp")),
        "hostenc_build_minimizers": bool(
            hostenc and hasattr(hostenc, "build_minimizers")),
        "aligned": al["result"], "umis": {k: um["result"][k] for k in (
            "total_records", "umi_assigned", "clustered", "singletons",
            "groups")},
        "consensus": cons, "primary_records": n_prim,
        "true_gene_share": n_map / max(n_prim, 1),
        "ge_share": n_ge / max(n_prim, 1), "data_s": round(gen_s, 2)}
    plain = {k: v for st in steps.values()
             for k, v in plain_bodies(st["launches"]).items()}
    bad = []
    if min(steps["scanfastq"]["launches"].get(k, 0)
           for k in ("edgescan", "bcsweep", "tilescan")) < 1:
        bad.append("scanfastq did not launch its kernels")
    if al["launches"].get("bandalign", 0) < 1:
        bad.append("the aligner did not launch band_align")
    if um["launches"].get("pairwise", 0) < 1 or \
            um["launches"]["pairwise"] != len(ed_calls) or \
            {d for d, _ in ed_calls} != {"cuda"}:
        bad.append(f"assignumis launched the pairwise kernel "
                   f"{um['launches'].get('pairwise', 0)} times for "
                   f"{len(ed_calls)} batched groups")
    if steps["computeconsensus"]["launches"].get("bandalign", 0) < 1:
        bad.append("computeconsensus did not launch band_align")
    if plain:
        bad.append(f"plain bodies ran: {plain}")
    if (n_prim < 0.95 * CHAIN_READS
            or chain["true_gene_share"] < CHAIN_MIN_SHARE
            or chain["ge_share"] < CHAIN_MIN_SHARE
            or not 0 < cons["written"] == cons["molecules"]):
        bad.append("outputs off the generator's truth")
    chain["s"] = round(time.time() - t0, 2)
    emit(chain)
    if bad:
        raise SystemExit(f"steps_1_to_4b: {bad}")
    launches["bandalign_align"] = al["launches"]["bandalign"]
    launches["pairwise"] = um["launches"]["pairwise"]

    # ---- run: the workflow through the port's CLI on the chained
    # phase's genome, refFlat, whitelist and reads; its subset run on cuda
    # and on cpu is the CUDA == CPU parity of Steps 1-3 ----
    run_ph, wf = workflow_phase("cuda", cdir, ref, refflat, cwl, genes,
                                n_sub)

    # the chained phase's parity of Step 4b on that subset: tagbamwithread
    # and the device engine's computeconsensus on each device's run output
    t0 = time.time()
    poa_cuda.band_align.launches = 0
    blobs = {d: tag_and_consensus(d, cdir / f"wf_{d}", cdir / f"par_{d}")
             for d in ("cuda", "cpu")}
    diff = sorted(k for k in set(blobs["cuda"]) | set(blobs["cpu"])
                  if blobs["cuda"].get(k) != blobs["cpu"].get(k))
    emit({"phase": "steps_4b_parity", "reads": n_sub,
          "files": len(blobs["cuda"]), "differ": diff,
          "consensus_records": blobs["cuda"]["consensus.fastq"].count(b"\n@")
          + blobs["cuda"]["consensus.fastq"].startswith(b"@"),
          "bandalign_launches_cuda": poa_cuda.band_align.launches,
          "s": round(time.time() - t0, 2)})
    if diff or len(blobs["cuda"]) != 3 or \
            not blobs["cuda"]["consensus.fastq"]:
        raise SystemExit(f"cuda/cpu Step 4b outputs differ: {diff}")

    # ---- precompile: the warm-up command in its own process ----
    t0 = time.time()
    pre = subprocess.run(
        [sys.executable, "-m", "sicelore_tpu_torch", "precompile"], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    done = [l for l in pre.stdout.splitlines()
            if l.startswith("precompile done: ")]
    pre_ms = ast.literal_eval(done[-1][len("precompile done: "):]) \
        if done else {}
    emit({"phase": "precompile", "rc": pre.returncode, "ms": pre_ms,
          "log": pre.stderr.splitlines()[-30:],
          "s": round(time.time() - t0, 2)})
    if pre.returncode or sorted(pre_ms) != sorted(
            ("encode_two_half", "encode_composite", "edgescan", "bcsweep",
             "tilefeed", "tilescan", "win1", "bandalign", "hostnw",
             "pairwise")) or \
            min(pre_ms.values()) <= 0:
        raise SystemExit(f"precompile: rc {pre.returncode}, {pre_ms}")

    # one entry a kernel source; the edge kernel's 5p chunk and launches
    # stand in its entry under *_5p keys
    src = {# not Pallas kernels: the host encoders and the device decodes
           # of the JAX route (encode_composite_tm + unpack_tm; v1:
           # encode_composite_2bit + unpack_2bit)
           "encode_two_half": ("sicelore_tpu_torch/csrc/encode.cu",
                               "sicelore_tpu/ops/edgescan.py:147",
                               "encode_two_half_3p"),
           "encode_composite": ("sicelore_tpu_torch/csrc/encode.cu",
                                "sicelore_tpu/models/readscan.py:734",
                                "encode_composite_3p"),
           "edgescan": ("sicelore_tpu_torch/csrc/edgescan.cu",
                        "sicelore_tpu/ops/edgescan_tpu.py:87", "edgescan"),
           "bcsweep": ("sicelore_tpu_torch/csrc/bcsweep.cu",
                       "sicelore_tpu/ops/bcsearch.py:34",
                       f"bcsweep_{SWEEP_LISTS[0]}"),
           "tilescan": ("sicelore_tpu_torch/csrc/tilescan.cu",
                        "sicelore_tpu/ops/tilescan_tpu.py:51", "tilescan"),
           "tilefeed": ("sicelore_tpu_torch/csrc/tilefeed.cu",
                        "sicelore_tpu/ops/tilescan_tpu.py:239", "tilefeed"),
           "bandalign": ("sicelore_tpu_torch/csrc/bandalign.cu",
                         "sicelore_tpu/ops/poa_tpu.py:251",
                         "bandalign_512_32"),
           "win1": ("sicelore_tpu_torch/csrc/win1.cu",
                    "sicelore_tpu/ops/editdist.py:265", "win1"),
           # not a Pallas kernel: the host engine's alignment, which the
           # JAX package runs on the host
           "hostnw": ("sicelore_tpu_torch/csrc/hostnw.cu",
                      "sicelore_tpu/ops/poa.py:33", "hostnw_wta"),
           # not a Pallas kernel: the jitted scan the JAX route runs
           "pairwise": ("sicelore_tpu_torch/csrc/pairwise.cu",
                        "sicelore_tpu/ops/editdist.py:210",
                        "pairwise_g288")}
    # the window search runs on the control path (the 3p and 5p runs take
    # the fused edge kernel): the control run's count
    launches["win1"] = launches_c["win1"]
    # the v1 composite encode runs on the control path too
    launches["encode_composite"] = launches_c["encode_composite"]
    kernels = []
    for name, (source, replaces, key) in src.items():
        r = results[key]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": None}
        # launches in the run phase's `run`; the edge wrapper counts its 5p
        # launches apart, as a share of all of them
        entry["launches_run"] = wf["launches"].get(name, 0) - (
            wf["launches"].get("edgescan_5p", 0) if name == "edgescan" else 0)
        # the mesh phase (the consensus for the band kernel, the scan for
        # the rest), each shard's share, and each rank of the
        # multiprocess phase
        entry["launches_mesh"] = launches_m.get(name, 0) - (
            launches_m["edgescan_5p"] if name == "edgescan" else 0)
        if name in mesh_kernels + ("bandalign",):
            entry["launches_mesh_per_shard"] = [
                sh.get(name, 0) for sh in (cons_shards if name == "bandalign"
                                           else scan_shards).per_shard]
        entry["launches_multiprocess"] = [
            rk["launches"].get(name, 0) - (rk["launches"]["edgescan_5p"]
                                           if name == "edgescan" else 0)
            for rk in ranks]
        if name == "edgescan":
            o = results["edgescan_5p"]
            entry.update({"device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"], "reads": r["reads"],
                          "ops_per_read": r["ops_per_read"],
                          "host_us": host_us["edgescan"],
                          "edge_case_mismatches":
                              results["edgescan_edge_cases"]["3p"],
                          # the 5p chunk (32,768 5p reads) and the 5p runs
                          "ms_5p": o["ms"], "device_ms_5p": o["device_ms"],
                          "burst_ms_5p": o["burst_ms"],
                          "plain_ms_5p": o["plain_ms"],
                          "bound_ms_5p": o["bound_ms"],
                          "bound_by_5p": o["bound_by"],
                          "ops_per_read_5p": o["ops_per_read"],
                          "host_us_5p": host_us["edgescan_5p"],
                          "edge_case_mismatches_5p":
                              results["edgescan_edge_cases"]["5p"],
                          "launches_5p": launches5["edgescan_5p"],
                          "launches_run_5p":
                              wf["launches"].get("edgescan_5p", 0),
                          "launches_mesh_5p": launches_m["edgescan_5p"],
                          "launches_multiprocess_5p": [
                              rk["launches"]["edgescan_5p"] for rk in ranks]})
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       o["max_abs_err"])
        if name.startswith("encode_"):
            o = results[f"{name}_5p"]
            ec = results["encode_edge_cases"]
            entry.update({"reads": r["reads"], "device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"], "share": r["share"],
                          "ms_5p": o["ms"], "device_ms_5p": o["device_ms"],
                          "burst_ms_5p": o["burst_ms"],
                          "plain_ms_5p": o["plain_ms"],
                          "bound_ms_5p": o["bound_ms"],
                          "edge_case_mismatches": sum(
                              v for k, v in ec["cases"].items()
                              if k.startswith(name[7:])),
                          "refused": ec["refused"],
                          "launches_3p": launches3[name],
                          "launches_5p": launches5[name],
                          "launches_control": launches_c[name]})
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       o["max_abs_err"])
            if name == "encode_two_half":
                entry.update({
                    "wrapper_host_us": r["wrapper_host_us"],
                    "chunk_call_split_us": r["chunk_call_split_us"],
                    "chunk_call_split_us_5p": o["chunk_call_split_us"]})
        if name == "tilescan":
            o = results["tilescan_fed"]
            entry.update({"device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"], "words": r["words"],
                          "sites": r["sites"],
                          "host_us": host_us["tilescan"],
                          "edge_case_mismatches":
                              results["tilescan_edge_cases"]["mismatches"],
                          # the fused route: the feed's rows of the chunk
                          "tiles_fed": o["tiles"], "ms_fed": o["ms"],
                          "device_ms_fed": o["device_ms"],
                          "burst_ms_fed": o["burst_ms"],
                          "plain_ms_fed": o["plain_ms"],
                          "bound_ms_fed": o["bound_ms"],
                          "sites_fed": o["sites"],
                          "launches_fused": launches["tilefeed"],
                          "launches_5p": launches5["tilescan"]})
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       o["max_abs_err"])
        if name == "tilefeed":
            entry.update({"device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"], "reads": r["reads"],
                          "covered": r["covered"],
                          "launches_5p": launches5["tilefeed"],
                          "edge_case_mismatches":
                              results["tilefeed_edge_cases"]["mismatches"]})
        if name == "bcsweep":
            # ms: the wrapper's call with the end position; *_nopos: the
            # main path's call; device_ms: the sweep and its merge on the
            # device; merge_device_ms: the merge kernel alone
            entry.update({"n_barcodes": SWEEP_LISTS[0],
                          "slices": r["slices"],
                          "device_ms": r["device_ms"],
                          "merge_device_ms": r["merge_device_ms"]})
            for suffix, key2 in (
                    ("_nopos", f"bcsweep_{SWEEP_LISTS[0]}_nopos"),
                    (f"_n{SWEEP_LISTS[1]}", f"bcsweep_{SWEEP_LISTS[1]}"),
                    (f"_n{SWEEP_LISTS[1]}_nopos",
                     f"bcsweep_{SWEEP_LISTS[1]}_nopos"),
                    (f"_b{SWEEP_SMALL_B}",
                     f"bcsweep_{SWEEP_LISTS[0]}_b{SWEEP_SMALL_B}"),
                    (f"_b{SWEEP_SMALL_B}_nopos",
                     f"bcsweep_{SWEEP_LISTS[0]}_b{SWEEP_SMALL_B}_nopos")):
                o = results[key2]
                entry.update({f"ms{suffix}": o["ms"],
                              f"device_ms{suffix}": o["device_ms"],
                              f"plain_ms{suffix}": o["plain_ms"],
                              f"bound_ms{suffix}": o["bound_ms"]})
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           o["max_abs_err"])
            entry["edge_case_mismatches"] = \
                results["bcsweep_edge_cases"]["mismatches"]
        if name == "bandalign":
            entry.update({"Lc": 512, "W": 32, "pairs": r["pairs"],
                          "device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"]})
            for Lc, W, _, _, _ in BAND_SHAPES[1:]:
                o = results[f"bandalign_{Lc}_{W}"]
                entry.update({f"ms_{Lc}_{W}": o["ms"],
                              f"device_ms_{Lc}_{W}": o["device_ms"],
                              f"burst_ms_{Lc}_{W}": o["burst_ms"],
                              f"plain_ms_{Lc}_{W}": o["plain_ms"],
                              f"bound_ms_{Lc}_{W}": o["bound_ms"],
                              f"pairs_{Lc}_{W}": o["pairs"]})
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           o["max_abs_err"])
            entry["edge_case_mismatches"] = \
                results["bandalign_edge_cases"]["mismatches"]
            # the aligner's gap buckets: launches in the chained run's
            # align step (`launches` is the consensus run's)
            entry["launches_align"] = launches["bandalign_align"]
            for Lc, _ in GAP_SHAPES:
                W = poa_cuda.w_for(Lc)
                o = results[f"bandalign_gap_{Lc}_{W}"]
                entry.update({f"ms_gap_{Lc}_{W}": o["ms"],
                              f"device_ms_gap_{Lc}_{W}": o["device_ms"],
                              f"burst_ms_gap_{Lc}_{W}": o["burst_ms"],
                              f"plain_ms_gap_{Lc}_{W}": o["plain_ms"],
                              f"bound_ms_gap_{Lc}_{W}": o["bound_ms"],
                              f"pairs_gap_{Lc}_{W}": o["pairs"]})
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           o["max_abs_err"])
        if name == "pairwise":
            # launches: the chained phase's assignumis (one a batched
            # group); the 3,000- and 8,192-UMI groups beside the timing
            # group under *_g3000 and *_g8192 keys
            entry.update({"umis": r["umis"], "device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"],
                          "wrapper_host_us": r["wrapper_host_us"],
                          "group_call_us": r["group_call_us"],
                          "group_call_split_us": r["group_call_split_us"],
                          "batched_groups_chain": chain["device_ed_calls"],
                          "batched_groups_run": run_ph["device_ed_calls"]})
            for g in ("g3000", "g8192"):
                o = results[f"pairwise_{g}"]
                entry.update({f"{k}_{g}": o[k] for k in (
                    "ms", "device_ms", "burst_ms", "plain_ms", "bound_ms",
                    "bound_by", "group_call_us", "group_call_split_us")})
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           o["max_abs_err"])
            edge = ("mixed", "bytes256")
            entry["edge_case_mismatches"] = sum(
                results[f"pairwise_{g}"]["mismatches"] for g in edge)
            entry["max_abs_err"] = max(
                entry["max_abs_err"],
                *(results[f"pairwise_{g}"]["max_abs_err"] for g in edge))
        if name == "hostnw":
            # launches: the consensus run's (routes n and long, one a
            # call); the deep-like pair set under *_deep keys; the route
            # against the host engine
            entry.update({"device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"], "pairs": r["pairs"],
                          "band_cells": r["band_cells"],
                          "scratch_bytes": r["scratch_bytes"],
                          "route": results["hostnw_route"]})
            o = results["hostnw_deep"]
            entry.update({f"{k}_deep": o[k] for k in (
                "ms", "device_ms", "burst_ms", "plain_ms", "bound_ms",
                "pairs", "band_cells", "scratch_bytes")})
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       o["max_abs_err"])
        if name == "win1":
            entry.update({"windows": r["windows"], "columns": r["columns"],
                          "device_ms": r["device_ms"],
                          "burst_ms": r["burst_ms"],
                          "host_us": host_us["win1"],
                          "launches_5p": launches5["win1"],
                          "edge_case_mismatches":
                              results["win1_edge_cases"]["mismatches"]})
            for k in ("adc", "tso", "confirm", "b37", "b1"):
                o = results[f"win1_{k}"]
                entry.update({f"ms_{k}": o["ms"],
                              f"device_ms_{k}": o["device_ms"],
                              f"burst_ms_{k}": o["burst_ms"],
                              f"plain_ms_{k}": o["plain_ms"],
                              f"bound_ms_{k}": o["bound_ms"],
                              f"windows_{k}": o["windows"],
                              f"columns_{k}": o["columns"]})
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           o["max_abs_err"])
        kernels.append(entry)
    emit({"summary": {"scanfastq_reads_per_s": round(total / run_s, 1),
                      "scanfastq_run_s": round(run_s, 3),
                      "scanfastq_5p_reads_per_s": round(total / run5_s, 1),
                      "scanfastq_5p_run_s": round(run5_s, 3),
                      "control_reads_per_s":
                          round(stats_c.total_reads / ctl_s, 1),
                      "control_falsely_assigned_share": false_share,
                      "encode_3p_device_ms":
                          results["encode_two_half_3p"]["device_ms"],
                      "encode_3p_chunk_call_us": results[
                          "encode_two_half_3p"]["chunk_call_split_us"],
                      "edge_3p_device_ms": results["edgescan"]["device_ms"],
                      "edge_5p_device_ms":
                          results["edgescan_5p"]["device_ms"],
                      "edge_5p_ms": results["edgescan_5p"]["ms"],
                      "edge_composed_5p_ms":
                          results["edge_composed_5p"]["ms"],
                      "tile_feed_device_ms":
                          results["tilefeed"]["device_ms"],
                      "tile_scan_fed_device_ms":
                          results["tilescan_fed"]["device_ms"],
                      "edge_composed_5p_split_ms":
                          results["edge_composed_5p"]["split_ms"],
                      "scanfastq_split_s": splits,
                      "consensus_umis_per_s": round(N_MOLECULES / cons_s, 1),
                      "consensus_run_s": round(cons_s, 3),
                      "consensus_split_s": cons_split,
                      "mesh_shards": len(mesh),
                      "mesh_reads_per_s": mesh_ph["reads_per_s"],
                      "mesh_umis_per_s": mesh_ph["umis_per_s"],
                      "multiprocess_reads_per_s": mp_ph["reads_per_s"],
                      "multiprocess_wall_s": mp_ph["wall_s"],
                      "align_reads_per_s": chain["align_reads_per_s"],
                      "assignumis_records_per_s":
                          chain["assignumis_records_per_s"],
                      "chain_step_s": chain["step_s"],
                      "run_stage_s": run_ph["stage_s"],
                      "run_align_reads_per_s": run_ph["align_reads_per_s"],
                      "chain_split_s": chain["split_s"],
                      "pairwise_device_ms": {
                          k: results[f"pairwise_{k}"]["device_ms"]
                          for k in GROUP_CALLS},
                      "pairwise_group_call_us": {
                          k: results[f"pairwise_{k}"]["group_call_us"]
                          for k in GROUP_CALLS},
                      "build_s": _build.build_seconds,
                      "script_s": round(time.time() - T_START, 1)}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
