#!/usr/bin/env python3
"""Smoke test of khmer_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ab OTHER_CHECKOUT [--lanes N ...] [--seed N]

Phases (any failure exits non-zero; nothing is caught):
  1. device: requires torch.cuda; prints the card's name and power limit;
  2. build: compiles the CUDA kernels (nvcc, sm_90a) and the native
     loader (g++) from the sources in the checkout;
  3. kernels: every kernel of the main path against its plain PyTorch
     version on the card, from the seed, at the main path's shapes;
     exact equality (all outputs are integers); CUDA-event times; K1
     also timed at k = 1 and 32; K2 also on a skewed batch (one hash on
     half the lanes: a hot partition), and each of K2's passes timed
     apart (torch.profiler); K3 also on 2**23 distinct keys, with the
     random 32-byte sectors it reads a second, and with each one
     table's geometry (the reads of phase 10's knot walk and stop-tag
     flags, Storage.get_lanes(tables=)), and on the same keys K3t and
     K20 (piece 0 of 4) alone by torch.profiler, for phases 13 (a) and
     14 (a); K4 on a chunk's distinct
     hashes, all absent and every count 0, and on a main-path window
     (the K2 batch's distinct hashes in first-occurrence order, half of
     them tracked);
  4. main path: load-into-counting (-k 20 -N 4 -x 1e8; its consume is
     the deferred counter on the whole table: K1, K16, K18 and K19) then
     abundance-dist-single and abundance-dist on synthetic 100-bp reads
     at 20x over a random 3.2 Mbase genome (bench.py's input), through
     the port's script entry points; then the overlay run,
     load-into-counting and abundance-dist on a 2 Mbase file with one
     read repeated 300 times (a .ct with a bigcount map).  Held against
     (a) the same runs through the plain versions on the card (.ct
     sha256, n_unique and histograms identical) and (b) an exact numpy
     count of the canonical k-mers (n_unique within the collision bound
     of the table sizes; both histogram totals equal to the distinct
     count, which is within one membership window).  Every kernel of
     this path must have been launched by this run (K13 and K14 by the
     .ct's save); its peak device memory is printed, and the save (K14's
     packing, the copy of its stream and the whole route, beside
     khmer_tpu's sparse alternative measured as a yardstick: the nonzero
     pairs by torch.nonzero, their copy and their host assembly), the
     load's widening and K13's count are timed on the loaded table beside
     the bytes that cross to the host and their calls on the path;
  3g. K13 (count_nonzero) and K14 (pack_oxli_bytes, each kind) against
     their plain versions on the card, bit for bit: the phase-4 .ct's
     table, an empty and a full table of its geometry (bins >= 2**31
     among them), tables one nonzero bin below and above each kind's
     khmer_tpu sparse-save threshold, and geometries of odd sizes;
  3b. slice-2 kernels against their plain versions on the card, exact:
     K5 on 16,384 rows x 148 codes of the phase-4 reads against the
     phase-4 .ct, with and without hashes (and K1 + K3 back to back on
     the same rows, timed beside it); K6 and K7 (also K7 with dn_cov)
     timed on five inputs: the first 16,384-bundle batch of the phase-5
     file with its pre-counts from the phase-4 .ct, the same batch with
     pre all zero (the first batch of a fresh run), the batch with every
     8th bundle a repeat of the one before it, 16,384 pairs sorted by
     position (each 10 bases after the one before it, pre all zero:
     every bundle taken, each sharing k-mers with the eight before it),
     and the batch's first bundle repeated 16,384 times (also at C =
     trim_at = 65535, every bundle taken); for each, ms, us a bundle,
     the rounds and walked bundles the kernel took (steps) and bundles
     a step;
  5. the slice-2 path: normalize-by-median -p -C 20 --savegraph,
     trim-low-abund -C 3 -Z 18 -V, filter-abund -C 2 (phase-4 .ct),
     filter-abund-single -C 2 and count-median (phase-4 .ct, the first
     100,000 reads), all at -k 20 -N 4 -x 1e8, on 640,000 interleaved
     100-bp reads in pairs (0.5% substitutions) at 40x over the first
     1.6 Mbase of the phase-4 genome (configs 2-3's 1,280,000 reads over
     3.2 Mbase, halved for the smoke's time limit), through the port's script entry points.  Held against (a)
     normalize-by-median's and count-median's runs through the plain
     versions on the card (every output file's sha256, reads and bases
     written, n_unique identical; the other three's plain runs were cut
     for the time limit) and
     (b) a numpy replay of the first batch's keep decisions from K3
     pre-counts.  K5, K6 and K7 must have been launched by this run; the
     walls, rates, device busy shares and peak device memory are
     printed, and each wall split into the seconds inside
     Countgraph.diginorm_batch / trim_pass1_batch (synchronised before
     and after each call) and the rest (parsing, pairing, trimming,
     writing).
  3c. murmur kernels against their plain versions on the card, exact:
     K8 on the first 16,384 phase-5 reads as ASCII rows (khmer_tpu's
     padding) at k = 20, 33 and 51, both complement forms, and on the
     same rows with a tenth of their bytes lowercase, N or IUPAC; K8's
     flat form (bulk-consume complement) on the first 2**23-base chunk
     of the phase-4 file; K5's murmur variant on the k = 51 rows against
     a 4 x 1e8 Counttable holding their k-mers, with and without hashes;
     K9 on that chunk at p = 14 (-e 0.01) and p = 16 (-e 0.005);
  6. the murmur path at full size: unique-kmers -k 20 and -k 51 (-e
     0.01 -R) over the phase-4 and phase-5 files in one call (a counter
     per file and their merged total), filter-abund-single -H murmur -k
     51 -C 2 and normalize-by-median -H murmur -k 51 -p -C 20 (no
     --savegraph: khmer_tpu refuses to save a murmur table) on the
     phase-5 file, -N 4 -x 1e8, through the port's script entry points.
     Held against the same runs through the plain versions on the card
     (HLL registers, every estimate printed, every output file's
     sha256, reads and bases kept, n_unique identical) and against
     exact counts: the k = 20 estimates of the phase-4 file and of the
     total within 3% of the distinct canonical k-mers (phase 4's numpy
     count, and its union with the phase-5 file's, counted with plain
     torch ops on the card).  K8, K9 and K5's murmur
     variant must have been launched by this run; walls, device busy
     shares and peak device memory are printed.
  7. tag-based partitioning (BASELINE config 5) at the documented
     workflow's flags (docs/user/partitioning-big-data.md), the table cut
     to -x 1e8: load-graph -k 32 -N 4 -x 1e8, partition-graph -s 1e5 (and
     a second run with --no-big-traverse on a copy of the graph),
     merge-partitions, annotate-partitions and extract-partitions on
     200,000 100-bp reads (0.5% substitutions, half reverse-complemented)
     over 500 random genomes of 1-8 kbases (the same coverage as phase
     10's 400,000 reads over 1,000 genomes: halved for the smoke's time
     limit), through the port's script
     entry points; then SubsetPartition.do_partition_device (K10) and
     do_partition on the loaded graph.  Held against (a) the same scripts
     through the plain versions on the card (every file in the working
     directory after every script identical) and (b) the device engine's
     partitions, as sets of tags, equal to do_partition's.  K1, K2, K3
     and K10 must have been launched by this run, and K14 by
     load-graph's dense bit save; walls, reads/s, device busy shares, the
     largest device items, tags, edges, CC rounds and peak device memory
     are printed.
  3d. K10 against its plain version on the card, exact: labels and the
     changed flag at rounds = 1 and 8 from arange labels, and the labels
     and number of calls at connected_components' fixpoint, on a path of
     2**22 nodes, a random graph of 2**22 nodes and 2**24 edges (an
     eighth of them repeats, an eighth padding (0, 0)) and phase 7's star
     edge list; CUDA-event times a call of 8 and of 1 round.
  3e. slice-3b kernels against their plain versions on the card, exact:
     K11 (cyclic_hashes) on the first 16,384 phase-5 reads as ASCII rows
     at k = 20, 51, 64, 65 and 128, and at k = 51 on the same rows with a
     tenth of their bytes lowercase, N or IUPAC; K11's flat form on the
     first 2**23-base chunk of the phase-4 file (phase 8's shape); K5c
     (row_counts, hash_kind "cyclic") at k = 20 (phase 8's shape) and 51
     against a 4 x 1e8 CyclicCounttable holding the rows' k-mers, with and
     without hashes;
  8. slice 3b's path through the port's script entry points, -k 20 -N 4
     -x 1e8: load-into-counting and abundance-dist-single --small-count
     on the phase-4 file; normalize-by-median -p -C 20 --savegraph,
     filter-abund-single -C 2, trim-low-abund -C 3 -Z 18 -V and
     trim-low-abund --loadgraph (the small .ct), all --small-count, on
     the first 160,000 reads of the phase-5 file (a quarter of it, cut
     for the smoke's time limit); then a CyclicCounttable(20, 1e8, 4):
     consume_seqfile and abundance_distribution of the phase-4 file,
     get_median_count_batch of the first 16,384 phase-5 reads, save,
     load and save again.  Held against (a) the same runs through the
     plain versions on the card (every output file, n_unique, the saved
     bytes identical), (b) the small .ct's bins equal to min(bin, 15) of
     phase 4's byte .ct, read with numpy alone, (c) the --small-count
     histogram equal to phase 4's abundance-dist-single histogram with
     every row at 15 or above summed into row 15, and (d) the cyclic
     n_unique within the collision bound of phase 4's exact distinct
     count; (e) K11, K5c and K3 at cap 15 must have been launched by
     this run.  Walls, device busy shares and peak device memory are
     printed.
  3f. K12 (band_mask_weights) against its plain version on the card,
     exact: the first 2**23-lane chunk of the phase-4 file with K1 and
     with K8 hashes; bands 0 and 3 of 4 and 1 of 2; the phase-4 .ct's
     table as the mask at its cap (thresholds 0 and 5, consume_masked
     both ways) and at cap 1 (a Nodegraph's read); band and mask
     together; the crafted hashes 0, 2**63 - 1, 2**63, the band's edges
     and 2**64 - 1.  CUDA-event times beside K3 on the same keys;
  9. slice 10's path through the port's public entry points, -k 20 -N 4
     -x 1e8: (a) a Counttable of the phase-4 file, then
     consume_seqfile_banding into four fresh tables, bands 0-3 of 4,
     whose bins sum to the full table's, consumed counts to its
     n_consumed and n_unique within the collision bound of the exact
     distinct count; (b) Countgraphs of the phase-5 file through
     consume_seqfile_with_mask of a Nodegraph of the phase-4 file
     (threshold 0, and 1 with consume_masked) that add up to the unmasked
     consume bin for bin and in consumed; (c) the same with a Nodetable
     mask and band 3 of 4 of a Counttable (above 2**63) through
     consume_seqfile_banding_with_mask against consume_seqfile_banding;
     (d) get_raw_tables of a Countgraph of the phase-4 file equal to the
     phase-4 .ct's table bytes, get_kmers and n_tables, and
     Nodegraph.update of the Nodegraphs of the two halves of the file
     equal to the whole file's; (e) every run of (a)-(c) equal to the
     same run through the plain versions on the card (results, bins,
     n_unique).  Walls, reads/s, device busy shares, K12 launches and
     peak device memory are printed.
  10. slice 4b's path, the knot-removal workflow of
     docs/user/partitioning-big-data.md, through the port's script entry
     points on 400,000 reads over 1,000 genomes (phase 7's metagenome at
     twice its size) of which 200
     carry two of four shared 400-base repeats (one lump): do-partition
     -k 32 -N 4 -x 1e8 -s 1e5; extract-partitions -X 20000 (the largest
     group is the lump); on the lump load-graph, make-initial-stoptags,
     partition-graph --stoptags and find-knots -x 2e8 -N 4;
     filter-stoptags; then load-graph, partition-graph, merge-,
     annotate- and extract-partitions of the cut reads (its plain-version
     runs of steps 1-4 were cut for the time limit: phase 3 holds K1-K3
     and bin_scatter_add to their plain versions); the stop tags must not
     be empty.  K1, K2, K3 and bin_scatter_add
     must have been launched by this run; walls, device busy shares, K3
     launches by script, the repartitions' batches, walks and traversals
     taken again, the stop-tag count, the lump's partitions before and
     after the filter and peak device memory are printed.
  11. slice 4c's path, labels, assembly and the read aligner, through
     the port's sandbox scripts: (a) correct-reads -k 20 -N 4 -x 1e8
     (-Z 20 -C 2 --theta 1.0) on 50,000 interleaved 100-bp reads at 40x
     over the first 0.125 Mbase of the phase-4 genome (0.5%
     substitutions); (b) sweep-reads --label-by-pid -x 1e8 -N 4 at the
     default radius: a reference of 100,000 reads over 100 random
     genomes of 1-8 kbases, each named with its genome's index, and
     40,000 reads of a second sample over them plus 4,000 from 10 absent
     genomes; (c) assemble-on-the-go on 5,000 100-bp reads at 40x over
     a 12.5 kbase genome of random stop-free codons (0.5% substitutions).
     Held against the same runs through the plain versions on the card
     (stdout, every stderr line and every output file identical); K1,
     K2, K3 and K5 must have been launched by this run.  Reads corrected,
     alignments, the native search's us an alignment, the snapshot's
     copies and ms (and a pinned copy of a table of the same size),
     labelled, multi-labelled and orphaned reads, ORFs, assemblies,
     assembler steps and us a step, K3 launches, walls and device busy
     shares are printed.
  12. the quotient filter (slice 5): normalize-by-median --mqf and
     --bmqf (-C 5) and trim-low-abund --mqf (-k 20, -U the exact
     distinct 20-mers) on the first 160,000 phase-5 reads, and a
     QFCounttable consume, save, load and query on the first 20,000.
     The scripts are held against the same runs through the plain
     versions on the card (stdout, every stderr line and every file);
     K8's hashes of all 160,000 reads against its plain version's, and
     the table against an oracle from them (n_unique before and after
     the load = the distinct keys, sampled counts exact); K8, K6 and K7
     must have been launched; walls, device busy shares and K8 launches
     are printed.
  13. the sharded consume, query and CC (slice 7a): (a) K15
     (band_route), K16 (combine_lanes), K17 (claim_scatter and
     claim_count), K3t (sketch_get_tables) and K10's relax and jump entry
     points against their plain versions, bit for bit (K16 after a sort
     by key; K3t also on 2**23 distinct random keys, with its time alone
     (phase 3's), the random sectors it reads a second and the
     library gather table[idx] beside it), on the first 2**23-lane chunk
     of the phase-4 file and a hot
     chunk (poly-A on half the lanes, which forces leftovers), the chunk's
     distinct lanes virgin and against the phase-4 .ct, and phase 7's
     star; (b) ShardedDeferredConsumer over a data=1, shard=4 mesh on the
     card, fed by the native loader with the phase-4 file at -k 20 -N 4
     -x 1e8: its delta equal to a serial consume's table bit for bit, its
     n_unique to phase 4's .ct, its n_consumed to the serial one, the
     sharded query of 2**20 hashes to K3 on the serial table, and the
     same run through the plain versions on the card equal; wall, stage
     ms, device busy, peak memory, routed bytes and rounds printed; (c)
     do_partition_device over the 4-shard mesh on phase 7's graph equal to
     the single-device engine; (d) distributed_count over two processes
     (this script with --dist-worker) on the first 160,000 phase-5 reads
     at -N 4 -x 1e7, one file, so that process 1 idles: NCCL where the
     machine shows two cards or more, else gloo with both on cuda:0
     (printed), its merged table and n_unique equal to a serial consume.
  14. the bin-sharded table (slice 15): (a) K18 (owned_claims: claims,
     then flags and bigcount candidates), K19 (owned_add) and K20
     (owned_get) against their plain versions, bit for bit (candidates
     as a set), on the first 2**23-lane chunk of the phase-4 file (its
     first lanes replaced by keys whose bins are every piece's first and
     last bin and the last table's last bin) on each of 4 pieces
     of the phase-4 .ct, K20's time alone (phase 3's) beside, with the
     owned sectors it reads a second; (b) Storage.shard_table over 4
     shards of the card, then consume_seqfile of the phase-4 file (the
     deferred counter, as phase 4's consume on the whole table): its
     saved .ct (bigcount section included), raw bytes, n_occupied and
     n_unique equal to phase 4's whole table; wall, stage ms, device
     busy, peak memory and each piece's bytes printed, and the same run
     through the plain versions equal; (d) a 4-piece Nodegraph
     of phase 7's geometry takes consume_seqfile_and_tag of phase 7's
     reads: its tags and raw bytes (packed a piece at a time by K14 in
     the bit kind) equal phase 7's graph, find_all_tags
     from three seeds and do_partition_device over the 4-shard mesh equal
     the whole graph's.  K18-K20 must have been launched by (b) and (d);
     K20's lanes per call over them are printed (median, total).
The last lines are the kernels JSON and {"ok": true, "device": ...}.

With --ab, instead of the phases: this checkout against OTHER_CHECKOUT
(another version of this repository, say the parent commit unpacked with
git archive) on the card, in four processes (other, this, this, other),
each with its checkout's khmer_tpu_torch: ptxas's report of the K3t and
K20 kernels (first two runs); K3t and K20 at 2**16 and 2**23 lanes and
each --lanes (a wrapper call by CUDA events, the kernel alone by
torch.profiler); phase 4's consume (walls, peak device memory above the
table, n_unique, the .ct's sha256).  Fails if the outputs differ; the
last line is one JSON object of every run's numbers and the card.
"""

import argparse
import contextlib
import gc
import io
import hashlib
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
STARTED = time.perf_counter()
K = 20
KS = (1, 2, 15, 16, 17, 20, 31, 32)
TABLE_SIZE = 1e8  # bins per table; 4 tables (bench.py's countgraph)
WINDOW = 1 << 25  # abundance_distribution's membership window on the card
SOURCES = {
    "hash2bit_canonical": ("khmer_tpu_torch/kernels/csrc/hash2bit.cu",
                           "khmer_tpu/ops/hashing.py:247"),
    "sketch_update": ("khmer_tpu_torch/kernels/csrc/sketch.cu",
                      "khmer_tpu/ops/sketch_ops.py:128"),
    "sketch_get": ("khmer_tpu_torch/kernels/csrc/sketch.cu",
                   "khmer_tpu/ops/sketch_ops.py:223"),
    "abund_hist": ("khmer_tpu_torch/kernels/csrc/abund.cu",
                   "khmer_tpu/hashtable.py:358"),
    "bin_scatter_add": ("khmer_tpu_torch/kernels/csrc/sketch.cu",
                        "benchmarks/explore_pallas_scatter.py:59"),
    "row_counts": ("khmer_tpu_torch/kernels/csrc/rows.cu",
                   "khmer_tpu/hashtable.py:472"),
    "diginorm_chain": ("khmer_tpu_torch/kernels/csrc/chain.cu",
                       "khmer_tpu/hashtable.py:760"),
    "trim_chain": ("khmer_tpu_torch/kernels/csrc/chain.cu",
                   "khmer_tpu/hashtable.py:499"),
    "murmur_hashes": ("khmer_tpu_torch/kernels/csrc/murmur.cu",
                      "khmer_tpu/ops/hashing.py:507"),
    "hll_update": ("khmer_tpu_torch/kernels/csrc/hll.cu",
                   "khmer_tpu/hllcounter.py:62"),
    "cc_rounds": ("khmer_tpu_torch/kernels/csrc/cc.cu",
                  "khmer_tpu/partition_device.py:42"),
    "cyclic_hashes": ("khmer_tpu_torch/kernels/csrc/cyclic.cu",
                      "khmer_tpu/ops/rollinghash.py:155"),
    "row_counts_cyclic": ("khmer_tpu_torch/kernels/csrc/rows.cu",
                          "khmer_tpu/hashtable.py:472"),
    "band_mask_weights": ("khmer_tpu_torch/kernels/csrc/filter.cu",
                          "khmer_tpu/hashtable.py:141"),
    "count_nonzero": ("khmer_tpu_torch/kernels/csrc/save.cu",
                      "khmer_tpu/ops/sketch_ops.py:234"),
    "pack_oxli_bytes": ("khmer_tpu_torch/kernels/csrc/save.cu",
                        "khmer_tpu/ops/sketch_ops.py:246"),
    "band_route": ("khmer_tpu_torch/kernels/csrc/route.cu",
                   "khmer_tpu/parallel/sharded.py:143"),
    "combine_lanes": ("khmer_tpu_torch/kernels/csrc/combine.cu",
                      "khmer_tpu/ops/deferred.py:297"),
    "claim_news": ("khmer_tpu_torch/kernels/csrc/claims.cu",
                   "khmer_tpu/parallel/sharded.py:344"),
    "sketch_get_tables": ("khmer_tpu_torch/kernels/csrc/sketch.cu",
                          "khmer_tpu/parallel/sharded.py:103"),
    "cc_relax": ("khmer_tpu_torch/kernels/csrc/cc.cu",
                 "khmer_tpu/partition_device.py:80"),
    "cc_jump": ("khmer_tpu_torch/kernels/csrc/cc.cu",
                "khmer_tpu/partition_device.py:80"),
    "owned_claims": ("khmer_tpu_torch/kernels/csrc/binshard.cu",
                     "khmer_tpu/ops/deferred.py:431"),
    "owned_add": ("khmer_tpu_torch/kernels/csrc/binshard.cu",
                  "khmer_tpu/ops/deferred.py:466"),
    "owned_get": ("khmer_tpu_torch/kernels/csrc/binshard.cu",
                  "khmer_tpu/storage.py:245"),
}
# the kernels each path must launch: phase 4 (slice 1: its consume is the
# deferred counter, K16 with the K18/K19 flush into the whole table; K2
# adds the histogram's tracking) and phase 5 (slice 2, which loads .ct
# files and counts as slice 1 does)
MAIN_PATH = ("hash2bit_canonical", "combine_lanes", "owned_claims",
             "owned_add", "sketch_update", "sketch_get", "abund_hist",
             "bin_scatter_add", "count_nonzero", "pack_oxli_bytes")
SLICE2_PATH = ("row_counts", "diginorm_chain", "trim_chain",
               "hash2bit_canonical", "sketch_update", "sketch_get",
               "bin_scatter_add")
# reads of the phase-5 file: 40x over the first 1.6 Mbase of the genome
# (configs 2-3's 1,280,000 reads over 3.2 Mbase, halved for the time limit)
SLICE2_READS = 640_000
SLICE2_COVERAGE = 40
BATCH = 16384  # bundles per normalize-by-median / trim-low-abund batch
# the phase-5 scripts run again through the plain versions (cut from all
# five for the time limit: trim-low-abund's, filter-abund's and
# filter-abund-single's took about 72 s; K5-K7 stay held to their plain
# versions in phase 3b, and phase 8 reruns trim-low-abund and
# filter-abund-single --small-count through the plain versions)
SLICE2_PLAIN = ("normalize-by-median", "count-median")
# the murmur path (phase 6): its k, K8's k in phase 3c, K9's register bits
MURMUR_K = 51
MURMUR_KS = (20, 33, MURMUR_K)
HLL_PS = (14, 16)  # -e 0.01 and 0.005
MURMUR_PATH = ("murmur_hashes", "hll_update", "row_counts", "sketch_update",
               "sketch_get", "diginorm_chain")
FLAT = 1 << 23  # bases of the flat chunk in phase 3c
# the save, the load's widening and the count, timed in phase 4
PACKING = ("pack_oxli_bytes", "unpack_oxli_bytes", "occupied_bins")
# the partitioning path (phase 7): BASELINE config 5 at the documented
# workflow's flags (docs/user/partitioning-big-data.md), the table cut
PARTITION_K = 32
# (halved from 1,000 genomes and 400,000 reads, the coverage kept, for the
# smoke's time limit; phase 10 keeps the full size)
PARTITION_GENOMES = 500
PARTITION_READS = 200_000
PARTITION_PATH = ("hash2bit_canonical", "sketch_update", "sketch_get",
                  "cc_rounds", "pack_oxli_bytes")
# slice 3b (phases 3e and 8): K11's k in phase 3e, the nibble kind's read
# cap, phase 8's cut of the phase-5 file and the kernels its path runs
CYCLIC_KS = (K, MURMUR_K, 64, 65, 128)
NIBBLE_CAP = 15
SMALL_READS = 160_000
SMALL_PATH = ("hash2bit_canonical", "sketch_update", "sketch_get",
              "abund_hist", "bin_scatter_add", "row_counts", "diginorm_chain",
              "trim_chain", "cyclic_hashes")
# slice 4b (phase 10): the knot-removal workflow on a metagenome of
# KNOT_READS reads over KNOT_GENOMES genomes (phase 7's, at full size) with
# KNOT_CARRIERS genomes carrying two of KNOT_REPEATS shared repeats;
# extract-partitions' groups of KNOT_GROUP reads put the lump in the largest
KNOT_GENOMES = 1000
KNOT_READS = 400_000
KNOT_CARRIERS = 200
KNOT_REPEATS = 4
KNOT_REPEAT_LEN = 400
KNOT_GROUP = 20000
KNOT_PATH = ("hash2bit_canonical", "sketch_update", "sketch_get",
             "bin_scatter_add")
# slice 4c (phase 11): correct-reads on CORRECT_READS reads at 40x over the
# first 0.125 Mbase of the phase-4 genome (configs 2-3's 3.2 Mbase cut, so
# that coverage passes -Z, and the reads halved from 100,000 for the
# smoke's time); sweep-reads of SWEEP_READS reads (and a tenth more from
# SWEEP_ABSENT genomes absent from the reference) against SWEEP_REF_READS
# reference reads over SWEEP_GENOMES random genomes; assemble-on-the-go on
# OTG_READS reads at 40x over a genome of OTG_GENOME bases of stop-free
# codons (40,000 reads over 0.1 Mbase cut to an eighth: the run is read by
# read, and the plain versions take about 7 ms a read)
CORRECT_READS = 50_000
CORRECT_COVERAGE = 40
SWEEP_GENOMES = 100
SWEEP_ABSENT = 10
SWEEP_REF_READS = 100_000
SWEEP_READS = 40_000
OTG_READS = 5_000
OTG_GENOME = 12_500
# slice 5 (phase 12): the kernels the quotient filter's path runs (the
# filter itself lives on the host) and its cut of the phase-5 file (the
# runs are host-bound: 111 s for the three scripts on the whole file, 46 s
# on its first 160,000 reads, before their plain runs)
QF_PATH = ("murmur_hashes", "diginorm_chain", "trim_chain")
QF_READS = 160_000
# the QFCounttable's reads: its save and load are the copied MQF codec's
# Python loop, about 7 us a key each way on the host
QF_TABLE_READS = 20_000
SLICE4C_PATH = ("hash2bit_canonical", "sketch_update", "sketch_get",
                "row_counts")
# slice 7a (phase 13): the sharded consume over SHARDS in-process shards of
# the one card, its query of SHARD_QUERY hashes, the kernels its path
# launches (K17 is claim_scatter and claim_count), and distributed_count
# over two processes on the first QF_READS phase-5 reads at -x DIST_TABLE
SHARDS = 4
SHARD_QUERY = 1 << 20
SLICE7A_PATH = ("hash2bit_canonical", "band_route", "combine_lanes",
                "claim_scatter", "claim_count", "bin_scatter_add",
                "sketch_get_tables")
DIST_TABLE = 1e7
# slice 15 (phase 14): the bin-sharded table in BINSHARD_PIECES pieces of
# the one card, and the kernels its path launches (K1 hashes the chunks
# and tags' rows, K16 combines the counter's cycles and ledger, K13 and
# K14 save, K10's relax and jump partition over the mesh)
BINSHARD_PIECES = 4
SLICE15_PATH = ("hash2bit_canonical", "combine_lanes", "owned_claims",
                "owned_add", "owned_get", "count_nonzero", "pack_oxli_bytes",
                "cc_relax", "cc_jump")


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, inner=5, warmup=1):
    """Device time of one call of fn: the median over reps groups of
    `inner` back-to-back calls, each group between two CUDA events made
    beforehand (so the host enqueues ahead of the card)."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        for _ in range(inner):
            fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / inner for a, b in pairs)


def max_abs_err(a, b):
    """0 for identical integer tensors, else the largest difference."""
    import torch

    if a.shape == b.shape and torch.equal(a, b):
        return 0
    if a.shape != b.shape:
        return float("inf")
    bad = torch.nonzero(a != b).squeeze(1)[:4096].cpu()
    x = a.cpu()[bad].tolist()
    y = b.cpu()[bad].tolist()
    return float(max(abs(int(u) - int(v)) for u, v in zip(x, y)))


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def record_kernel(rec, name, err, ms, plain_ms, nbytes, library_ms=None,
                  **extra):
    """Keep and print one kernel's check and times; fail on a mismatch."""
    rec[name] = dict(match=err == 0, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                     bound_by="bytes", library_ms=library_ms, **extra)
    log("kernel {:20s} max_abs_err={} ms={:.4f} plain_ms={:.4f} "
        "bound_ms={:.4f} library_ms={}{}".format(
            name, err, ms, plain_ms, bound_ms(nbytes), library_ms,
            "".join(" {}={}".format(k, v) for k, v in extra.items())))
    if err != 0:
        fail("{} disagrees with its plain version".format(name))


def kernel_ms_by_name(fn, reps):
    """Device time per call of fn by CUDA kernel name (torch.profiler),
    over reps calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    # the raw kineto events, as device_share reads them: late in the smoke
    # prof.events() came back without the device's events
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().replace("(anonymous namespace)::", "").split(
                "(")[0]
            by_name[name] = by_name.get(name, 0.0) + \
                e.duration_ns() / 1e6 / reps
    return by_name


def k4_timed(keys, table, geom, track, t_geom, cap=65535):
    """K4 against its plain version on one input, and its CUDA-event
    times.  bytes: what the input needs moved -- each key once, the
    tracking bins of each key up to its first zero, the main bins of
    the new keys, the flags, and the histogram in and out."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    out = {}
    for side, fn in (("kernel", kernels.abund_hist),
                     ("plain", plain.abund_hist)):
        hist = torch.zeros(65536, dtype=torch.int64, device=keys.device)
        new = fn(keys, table, *geom, track, *t_geom, cap, hist)
        out[side] = (hist, new)
    err = max(max_abs_err(a, b) for a, b in zip(out["kernel"],
                                                out["plain"]))
    hist, new = out["plain"]
    n, T = keys.numel(), t_geom[0].numel()
    zero = plain.sketch_get(track, keys, *t_geom, 1) == 0
    tb = track[plain._bins(keys, *t_geom[:2])] == 0
    reads = torch.where(zero, tb.to(torch.int8).argmax(0) + 1, T)
    del tb
    n_new = int(new.sum())
    # the random bins it reads: tracking up to a first zero, main if new
    sectors = int(reads.sum()) + n_new * geom[0].numel()
    nbytes = n * (8 + 4) + sectors * 4 + 65536 * 8 * 2
    ms = cuda_ms(lambda: kernels.abund_hist(keys, table, *geom, track,
                                            *t_geom, cap, hist), 10)
    return dict(
        err=err, n=n, new=n_new, bytes=nbytes, ms=ms,
        sectors_per_s=sectors / (ms * 1e-3),
        plain_ms=cuda_ms(lambda: plain.abund_hist(keys, table, *geom,
                                                  track, *t_geom, cap,
                                                  hist), 3))


def check_kernels(seed, dev, lanes=1 << 23, table_size=1e8,
                  scatter_bins=100_000_003, scatter_lanes=1 << 24,
                  tracked=3_200_000):
    import torch

    from khmer_tpu_torch import _u64, kernels
    from khmer_tpu_torch.hashtable import CHUNK, _first_of_runs
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.ops.sketch_ops import (BIGCOUNT_LANES, SketchSpec,
                                                alloc_table)
    from khmer_tpu_torch.primes import get_n_primes_near_x

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rec = {}

    def record(*args, **kwargs):
        record_kernel(rec, *args, **kwargs)

    # K1 on one main-path chunk (hashtable.CHUNK bases) at every edge-case k
    n = CHUNK
    log("phase 3: K1 and K4 on {}-base chunks, K2 and K3 on {}-lane "
        "batches".format(n, lanes))
    codes = torch.randint(0, 4, (n,), generator=g, device=dev,
                          dtype=torch.uint8)
    mask = (torch.rand(n, generator=g, device=dev) < 0.95).to(torch.uint8)
    err = 0
    for k in KS:
        h, w = kernels.hash2bit_canonical(codes, mask, k)
        ph, pw = plain.hash2bit_canonical(codes, mask, k)
        err = max(err, max_abs_err(h, ph), max_abs_err(w, pw))
        if k == K:
            chunk_h, chunk_w = h, w
    # the time at k = 1 and 32 beside k = 20 shows whether it grows with k
    by_k = {k: cuda_ms(lambda: kernels.hash2bit_canonical(codes, mask, k),
                       20) for k in (1, K, 32)}
    record("hash2bit_canonical", err, by_k[K],
           cuda_ms(lambda: plain.hash2bit_canonical(codes, mask, K), 3),
           n * (1 + 1 + 8 + 4), k1_ms=by_k[1], k32_ms=by_k[32])

    # K2 on a pre-filled 4 x 1e8 sketch with a 2**23-lane batch full of
    # duplicates (about 8 lanes per distinct hash) and masked lanes, and
    # on a skewed batch: one hash on half the lanes (a hot partition in
    # every table, as poly-A reads make), the rest as before
    spec = SketchSpec("byte", tuple(get_n_primes_near_x(4, table_size)))
    geom = spec.geometry(dev)
    T = spec.n_tables
    table = alloc_table(spec, dev)
    fill = torch.randint(0, spec.total_bins, (spec.total_bins // 10,),
                         generator=g, device=dev)
    table[fill] = torch.randint(1, 250, fill.shape, generator=g, device=dev,
                                dtype=torch.int32)
    del fill
    n_distinct = lanes // 8
    hi, lo = torch.randint(0, 1 << 32, (2, n_distinct), generator=g,
                           device=dev, dtype=torch.int64)
    hashes = ((hi << 32) | lo)[torch.randint(0, n_distinct, (lanes,),
                                            generator=g, device=dev)]
    del hi, lo
    weights = (torch.rand(lanes, generator=g, device=dev) < 0.9).to(
        torch.int32)
    skewed = hashes.clone()
    skewed[torch.randperm(lanes, generator=g, device=dev)[:lanes // 2]] = \
        hashes[0]

    def k2_check(batch):
        outs = {}
        for side, fn in (("kernel", kernels.sketch_update),
                         ("plain", plain.sketch_update)):
            t = table.clone()
            nu = torch.zeros(1, dtype=torch.int64, device=dev)
            cand = torch.zeros(BIGCOUNT_LANES, dtype=torch.int64, device=dev)
            cnt = torch.zeros(1, dtype=torch.int32, device=dev)
            is_new = fn(t, batch, weights, *geom, nu, cand, cnt)
            outs[side] = [t, nu, is_new, cnt]
            # an overflowed buffer holds an arbitrary subset: count only
            if int(cnt.item()) <= BIGCOUNT_LANES:
                outs[side].append(torch.sort(cand[:int(cnt.item())]).values)
        return max(max_abs_err(a, b) for a, b in zip(outs["kernel"],
                                                     outs["plain"])), \
            outs["kernel"]

    def k2(fn, batch):
        nu = torch.zeros(1, dtype=torch.int64, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        cand = torch.empty(BIGCOUNT_LANES, dtype=torch.int64, device=dev)
        return lambda: fn(table, batch, weights, *geom, nu, cand, cnt)

    err_skew, out = k2_check(skewed)
    c = int(out[3].item())
    if c < lanes // 4:
        fail("K2 skewed check: {} candidate lanes, expected at least {} "
             "(the hot hash's live lanes cross 255)".format(c, lanes // 4))
    del out
    err, out = k2_check(hashes)
    c = int(out[3].item())
    if c > BIGCOUNT_LANES or c == 0:
        fail("K2 check: {} candidate lanes, expected 1..{}".format(
            c, BIGCOUNT_LANES))
    post = out[0]
    del out
    for name, batch in (("batch", hashes), ("skewed", skewed)):
        passes = kernel_ms_by_name(k2(kernels.sketch_update, batch), 5)
        log("K2 passes on the {} ({} [{}]): {}".format(
            name, "ms per call, torch.profiler", card_line(),
            "; ".join("{} {:.4f}".format(k, v) for k, v in
                      sorted(passes.items(), key=lambda kv: -kv[1]))))
    # table traffic: the bins of each distinct live hash, read and written
    live = weights != 0
    n_live = int(live.sum())
    distinct_live = int(torch.unique(hashes[live]).numel())
    del live
    skew_ms = cuda_ms(k2(kernels.sketch_update, skewed), 5)
    record("sketch_update", max(err, err_skew),
           cuda_ms(k2(kernels.sketch_update, hashes), 5),
           cuda_ms(k2(plain.sketch_update, hashes), 2),
           lanes * (4 + 1) + n_live * 8 + distinct_live * T * (4 + 4),
           skewed_ms=skew_ms, skewed_max_abs_err=err_skew)
    del table, skewed

    # K3 under each read cap, on the updated sketch, on two inputs: the
    # K2 batch (about 8 lanes per distinct hash, so part of the table's
    # sectors come from L2) and 2**23 distinct keys (each of its 4 bins a
    # random 32-byte sector from device memory: the shape of per-read
    # count reads).  No one PyTorch call computes K3's function; the
    # gather of precomputed bins and its min is printed beside it as
    # gather_min_ms (bins [T, n], table by table, as K3's plain version
    # orders them) and keymajor_gather_min_ms (bins [n, T], key by key,
    # as K3 reads them).
    hi, lo = torch.randint(0, 1 << 32, (2, lanes), generator=g, device=dev,
                           dtype=torch.int64)
    k3 = {}
    for name, keys in (("batch", hashes), ("distinct", (hi << 32) | lo)):
        err = 0
        for cap in (255, 65535, 1):
            err = max(err, max_abs_err(
                kernels.sketch_get(post, keys, *geom, cap),
                plain.sketch_get(post, keys, *geom, cap)))
        # one table's geometry, as Storage.get_lanes(tables=slice(t, t +
        # 1)) reads it for the knot walk and the stop-tag flags (phase 10)
        for t in range(T):
            one = tuple(x[t:t + 1] for x in geom)
            for cap in (0xFFFF, 1):
                err = max(err, max_abs_err(
                    kernels.sketch_get(post, keys, *one, cap),
                    plain.sketch_get(post, keys, *one, cap)))
        n_keys = int(torch.unique(keys).numel())
        bins = plain._bins(keys, *geom[:2])
        ms = cuda_ms(lambda: kernels.sketch_get(post, keys, *geom, 65535),
                     10)
        k3[name] = dict(
            err=err, n=n_keys, ms=ms,
            plain_ms=cuda_ms(lambda: plain.sketch_get(post, keys, *geom,
                                                      65535), 3),
            gather_min_ms=cuda_ms(lambda: torch.amin(post[bins], dim=0), 5),
            bytes=lanes * (8 + 2) + n_keys * 4 * T,
            sectors_per_s=lanes * T / (ms * 1e-3))
        bins = bins.T.contiguous()
        k3[name]["keymajor_gather_min_ms"] = cuda_ms(
            lambda: torch.amin(post[bins], dim=1), 5)
        del bins
    rec["alone"] = gathers_alone(post, (hi << 32) | lo, spec, geom)
    del hi, lo
    a, b = k3["batch"], k3["distinct"]
    record("sketch_get", max(a["err"], b["err"]), a["ms"], a["plain_ms"],
           a["bytes"], gather_min_ms=a["gather_min_ms"],
           keymajor_gather_min_ms=a["keymajor_gather_min_ms"],
           sectors_per_s=a["sectors_per_s"], distinct_ms=b["ms"],
           distinct_plain_ms=b["plain_ms"],
           distinct_bound_ms=bound_ms(b["bytes"]), distinct_keys=b["n"],
           distinct_gather_min_ms=b["gather_min_ms"],
           distinct_keymajor_gather_min_ms=b["keymajor_gather_min_ms"],
           distinct_sectors_per_s=b["sectors_per_s"],
           distinct_max_abs_err=b["err"])

    # K4 on two inputs.  (a) The chunk's live hashes, distinct, all absent
    # from a tracking filter of 4 x 1e8 bins that holds `tracked` (3.2 M,
    # the bench's distinct count) other keys,
    # every count 0 (one hot histogram bin).  (b) A main-path window: the
    # K2 batch's distinct hashes in order of first occurrence, counts
    # spread by the batch, every other one of them in tracking.
    t_spec = SketchSpec("bit", spec.tablesizes)
    track = alloc_table(t_spec, dev)
    hi, lo = torch.randint(0, 1 << 32, (2, tracked), generator=g,
                           device=dev, dtype=torch.int64)
    other = (hi << 32) | lo
    del hi, lo
    kernels.sketch_update(track, other, torch.ones_like(other,
                                                        dtype=torch.int32),
                          *geom, torch.zeros(1, dtype=torch.int64,
                                             device=dev))
    del other
    keys_a = torch.unique(chunk_h[chunk_w != 0])
    zero_main = alloc_table(spec, dev)
    k4 = {"a": k4_timed(keys_a, zero_main, geom, track, geom)}
    del zero_main, keys_a
    keys_b, first = _first_of_runs(_u64.sort_key(hashes))
    keys_b = _u64.sort_key(keys_b[torch.argsort(first)])
    del first
    track.zero_()
    every_other = keys_b[::2].contiguous()
    kernels.sketch_update(track, every_other, torch.ones_like(
        every_other, dtype=torch.int32), *geom,
        torch.zeros(1, dtype=torch.int64, device=dev))
    del every_other
    k4["b"] = k4_timed(keys_b, post, geom, track, geom)
    del keys_b, track
    a, b = k4["a"], k4["b"]
    record("abund_hist", max(a["err"], b["err"]), a["ms"], a["plain_ms"],
           a["bytes"], keys=a["n"], new=a["new"],
           sectors_per_s=a["sectors_per_s"],
           window_sectors_per_s=b["sectors_per_s"],
           window_ms=b["ms"], window_plain_ms=b["plain_ms"],
           window_bound_ms=bound_ms(b["bytes"]), window_keys=b["n"],
           window_new=b["new"], window_max_abs_err=b["err"])
    del post, hashes, weights
    gc.collect()
    torch.cuda.empty_cache()

    # bin_scatter_add at the Pallas prototype's own shape: B bins, N
    # sorted unique bins, values in [1, 5)
    B, N = scatter_bins, scatter_lanes
    idx = torch.sort(torch.randperm(B, generator=g, device=dev)[:N]).values
    vals = torch.randint(1, 5, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    tk = torch.zeros(B, dtype=torch.int32, device=dev)
    tp = torch.zeros_like(tk)
    kernels.bin_scatter_add(tk, idx, vals)
    plain.bin_scatter_add(tp, idx, vals)
    # the wrapper is timed whole: its launches and its one read of the
    # out-of-range count
    record("bin_scatter_add", max_abs_err(tk, tp),
           cuda_ms(lambda: kernels.bin_scatter_add(tk, idx, vals), 10),
           cuda_ms(lambda: plain.bin_scatter_add(tp, idx, vals), 10),
           N * (8 + 4 + 4 + 4),
           cuda_ms(lambda: tp.index_add_(0, idx, vals), 10))
    for name, fn in (("bin_scatter_add",
                      lambda: kernels.bin_scatter_add(tk, idx, vals)),
                     ("index_add_", lambda: tp.index_add_(0, idx, vals))):
        passes = kernel_ms_by_name(fn, 5)
        log("{} passes (ms per call, torch.profiler [{}]): {}".format(
            name, card_line(), "; ".join(
                "{} {:.4f}".format(k, v) for k, v in
                sorted(passes.items(), key=lambda kv: -kv[1]))))
    del idx, vals, tk, tp
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------


def make_reads(path, seed, genome_mb=3.2, coverage=20, readlen=100):
    """bench.py's synthetic read set (20x over a random genome), from the
    seed; returns the reads as a [R, readlen] array of ASCII bases."""
    rng = np.random.default_rng(seed)
    G = int(genome_mb * 1e6)
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    n_reads = G * coverage // readlen
    starts = rng.integers(0, G - readlen, n_reads)
    seqs = np.frombuffer(b"ACGT", np.uint8)[
        genome[starts[:, None] + np.arange(readlen)]]
    rec = np.empty((n_reads, 1 + 8 + 1 + readlen + 1), np.uint8)
    rec[:, 0] = ord(">")
    ids = np.arange(n_reads, dtype=np.int64)
    pows = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    rec[:, 1:9] = (ids[:, None] // pows) % 10 + ord("0")
    rec[:, 9] = ord("\n")
    rec[:, 10:10 + readlen] = seqs
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return seqs


def exact_kmers(seqs, k):
    """Distinct canonical k-mers and their counts, exactly, in numpy."""
    lut = np.zeros(256, np.uint64)
    for ch, code in ((b"A", 0), (b"T", 1), (b"C", 2), (b"G", 3)):
        lut[ch[0]] = code
    codes = lut[seqs]
    w = seqs.shape[1] - k + 1
    f = np.zeros((seqs.shape[0], w), np.uint64)
    r = np.zeros_like(f)
    for j in range(k):
        c = codes[:, j:j + w]
        f = (f << np.uint64(2)) | c
        r |= (c ^ np.uint64(1)) << np.uint64(2 * j)
    return np.unique(np.minimum(f, r).ravel(), return_counts=True)


def make_overlay_reads(path, seed, n_reads=20000, genome_len=200_000,
                       readlen=100, repeats=300):
    """Random reads over a 200 kb genome (2 Mbases, two of the overlay
    path's 2**20-base membership chunks), then one of them repeated 300
    times: its k-mers pass 255, so load-into-counting writes a bigcount
    map and abundance-dist on that .ct takes the overlay path."""
    rng = np.random.default_rng(seed + 1)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - readlen, n_reads)
    seqs = np.frombuffer(b"ACGT", np.uint8)[
        genome[starts[:, None] + np.arange(readlen)]]
    seqs = np.concatenate([seqs, np.repeat(seqs[:1], repeats, 0)])
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">o{}\n{}\n".format(i, s.tobytes().decode()))


def run_scripts(workdir, fa, overlay_fa, dev):
    """load-into-counting, abundance-dist-single and abundance-dist on
    the card through the port's script entry points, then the overlay
    run: load-into-counting and abundance-dist on the small file whose
    .ct carries a bigcount map."""
    from khmer_tpu_torch.scripts import (abundance_dist,
                                         abundance_dist_single,
                                         load_into_counting)

    os.makedirs(workdir)
    ct = os.path.join(workdir, "reads.ct")
    overlay_ct = os.path.join(workdir, "overlay.ct")
    table = ["-k", str(K), "-N", "4", "-x", repr(TABLE_SIZE)]
    walls = {}
    for name, fn, argv in (
            ("load-into-counting", load_into_counting.main,
             ["-q"] + table + [ct, fa]),
            ("abundance-dist-single", abundance_dist_single.main,
             ["-q"] + table + [fa, os.path.join(workdir, "single.hist")]),
            ("abundance-dist", abundance_dist.main,
             ["-q", ct, fa, os.path.join(workdir, "dist.hist")]),
            ("overlay load-into-counting", load_into_counting.main,
             ["-q", "-k", str(K), "-N", "4", "-x", "1e6", overlay_ct,
              overlay_fa]),
            ("overlay abundance-dist", abundance_dist.main,
             ["-q", overlay_ct, overlay_fa,
              os.path.join(workdir, "overlay.hist")])):
        t0 = time.perf_counter()
        fn(argv, device=dev)
        sync(dev)
        walls[name] = time.perf_counter() - t0
        gc.collect()
    out = {"walls": walls}
    for key, path in (("ct_sha256", ct), ("overlay_ct_sha256", overlay_ct)):
        with open(path, "rb") as f:
            out[key] = hashlib.sha256(f.read()).hexdigest()
    with open(ct + ".info") as f:
        out["n_unique"] = int([ln for ln in f if ln.startswith(
            "Total number of unique k-mers:")][0].split(":")[1])
    for h in ("single.hist", "dist.hist", "overlay.hist"):
        with open(os.path.join(workdir, h), "rb") as f:
            out[h] = f.read()
    return out


def hist_total(csv):
    """Sum of the count column of an abundance-dist CSV."""
    return sum(int(line.split(b",")[1]) for line in csv.splitlines()[1:])


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main_path(seed, card, dev, tmp, genome_mb=3.2):
    import torch

    from khmer_tpu_torch import Countgraph, Nodegraph, kernels, storage
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.primes import get_n_primes_near_x

    fa = os.path.join(tmp, "reads.fa")
    overlay_fa = os.path.join(tmp, "overlay.fa")
    t0 = time.perf_counter()
    seqs = make_reads(fa, seed, genome_mb)
    make_overlay_reads(overlay_fa, seed)
    n_bases = seqs.size
    n_kmers = seqs.shape[0] * (seqs.shape[1] - K + 1)
    log("reads: {} x {} bp, {} bases, {} k-mers, {:.1f} s to write".format(
        seqs.shape[0], seqs.shape[1], n_bases, n_kmers,
        time.perf_counter() - t0))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    # the save's and load's byte packing (plain torch and numpy): calls
    packing = dict.fromkeys(PACKING, 0)

    def counted(name):
        fn = getattr(storage, name)

        def call(*a, **kw):
            packing[name] += 1
            return fn(*a, **kw)
        return call

    with mock.patch.multiple(storage, **{n: counted(n) for n in PACKING}):
        got = run_scripts(os.path.join(tmp, "kernels"), fa, overlay_fa, dev)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("main path launches: {}".format(json.dumps(launches)))
    log("main path peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    log("main path walls (s): {} [{}]".format(json.dumps(got["walls"]),
                                              card))
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the main path: {}".format(missing))

    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = run_scripts(os.path.join(tmp, "plain"), fa, overlay_fa, dev)
    log("plain-version walls (s): {} [{}]".format(json.dumps(ref["walls"]),
                                                  card))
    for key in ("ct_sha256", "n_unique", "single.hist", "dist.hist",
                "overlay_ct_sha256", "overlay.hist"):
        if got[key] != ref[key]:
            fail("main path differs from its plain run in " + key)
    log("kernels == plain on the card: .ct sha256 {}, n_unique {}, "
        "histograms identical; overlay run .ct sha256 {}, histogram "
        "identical".format(got["ct_sha256"], got["n_unique"],
                           got["overlay_ct_sha256"]))
    big = [line for line in got["overlay.hist"].splitlines()[1:]
           if int(line.split(b",")[0]) > 255]
    if not big:
        fail("the overlay run's histogram has no abundance above 255")
    log("overlay run: histogram total {}, {} abundances above 255 from "
        "the loaded bigcount map".format(hist_total(got["overlay.hist"]),
                                         len(big)))

    t0 = time.perf_counter()
    uniq, counts = exact_kmers(seqs, K)
    distinct = int(uniq.size)
    totals = {h: hist_total(got[h]) for h in ("single.hist", "dist.hist")}
    occ = 1.0 - math.exp(-distinct / min(get_n_primes_near_x(4, TABLE_SIZE)))
    expected = distinct * occ ** 4
    bound = int(math.ceil(10 * expected)) + 10
    log("exact numpy count: {} distinct canonical k-mers ({:.1f} s); "
        "n_unique {}; histogram totals {}; collision bound {} (expected "
        "{:.2f} colliding k-mers over 4 tables of ~{:.0e} bins)"
        .format(distinct, time.perf_counter() - t0, got["n_unique"],
                totals, bound, expected, TABLE_SIZE))
    if not 0 <= distinct - got["n_unique"] <= bound:
        fail("n_unique {} is not within {} below the exact {}".format(
            got["n_unique"], bound, distinct))
    # at most one membership window of distinct keys: each is tested
    # against the empty tracking filter, so each counts once
    if distinct <= WINDOW:
        for name, v in totals.items():
            if v != distinct:
                fail("{} total {} is not the exact distinct count {}"
                     .format(name, v, distinct))
    if int(counts.sum()) != n_kmers:
        fail("exact count lost k-mers")

    # consume and histogram passes timed on their own
    cg = Countgraph(K, TABLE_SIZE, 4, device=dev)
    cg.set_use_bigcount(True)
    sync(dev)
    t0 = time.perf_counter()
    cg.consume_seqfile(fa)
    nu = cg.n_unique_kmers()
    t_consume = time.perf_counter() - t0
    tracking = Nodegraph(K, 1, 1, primes=cg.hashsizes(), device=dev)
    sync(dev)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cg.abundance_distribution(fa, tracking)
    t_hist = time.perf_counter() - t0
    log("histogram pass: peak device memory {} bytes above the {} bytes "
        "of the two tables (the ledger, its sorts and a chunk) [{}]".format(
            torch.cuda.max_memory_allocated() - held, held, card))
    if nu != got["n_unique"]:
        fail("timed consume gave another n_unique")
    for name, secs in (("consume", t_consume), ("histogram", t_hist)):
        log("{}: {:.3f} s, {:.2f} Mbases/s, {:.2f} M k-mers/s [{}]".format(
            name, secs, n_bases / secs / 1e6, n_kmers / secs / 1e6, card))
    ct = os.path.join(tmp, "timed.ct")
    sync(dev)
    t0 = time.perf_counter()
    cg.save(ct)
    t_save = time.perf_counter() - t0
    del cg, tracking
    sync(dev)
    t0 = time.perf_counter()
    loaded = Countgraph.load(ct, device=dev)
    sync(dev)
    log("save: {:.3f} s, load: {:.3f} s ({} byte .ct) [{}]".format(
        t_save, time.perf_counter() - t0, os.path.getsize(ct), card))
    time_packing(loaded.storage, packing, dev, card)
    del loaded
    if dev.type == "cuda":
        cg = Countgraph(K, TABLE_SIZE, 4, device=dev)
        device_share("consume", lambda: cg.consume_seqfile(fa), card)
        tracking = Nodegraph(K, 1, 1, primes=cg.hashsizes(), device=dev)
        device_share("histogram",
                     lambda: cg.abundance_distribution(fa, tracking), card)
    return launches, uniq


def time_packing(st, calls, dev, card):
    """The save on a loaded 4 x 1e8-bin table on the card, each part
    apart: K14 (the stream packed), the pageable copy of the stream and
    the whole of raw_bytes; beside it, as a yardstick, khmer_tpu's sparse
    save of the same table (storage.py:300-313) done with library calls:
    the nonzero (bin, value) pairs by torch.nonzero and indexing, their
    pageable copy, and the stream's assembly from them on the host.  Then
    the load's widening and K13's count.  Walls of one call,
    synchronised, median of three, with the bytes that cross to the host
    and the calls on the main path."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.ops.sketch_ops import occupied_bins, unpack_oxli_bytes

    spec = st.spec
    sizes, offsets, _ = spec.geometry(dev)

    def wall(fn):
        times = []
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    def pairs():
        at = torch.nonzero(st.table[:spec.total_bins]).squeeze(1)
        return at.to(torch.int32), st.table[at]

    def assemble(idx, vals):
        # the byte kind's stream: one sparse store into a zeroed stream
        out = np.zeros(spec.total_bytes, np.uint8)
        out[idx.view(np.uint32)] = np.minimum(vals.view(np.uint32), 255)
        return out

    stream = kernels.pack_oxli_bytes(st.table, spec.kind, sizes, offsets,
                                     spec.bytes_per_table)
    raw = stream.cpu().numpy()
    idx, vals = pairs()
    hidx, hvals = idx.cpu().numpy(), vals.cpu().numpy()
    if spec.kind != "byte" or not np.array_equal(assemble(hidx, hvals), raw):
        fail("the sparse yardstick gives another stream than K14")
    parts = {
        "K14": wall(lambda: kernels.pack_oxli_bytes(
            st.table, spec.kind, sizes, offsets, spec.bytes_per_table)),
        "copy of the stream": wall(lambda: stream.cpu()),
        "raw_bytes": wall(st.raw_bytes),
        "yardstick: pairs (torch.nonzero, indexing)": wall(pairs),
        "yardstick: copy of the pairs": wall(lambda: (idx.cpu(),
                                                      vals.cpu())),
        "yardstick: host assembly": wall(lambda: assemble(hidx, hvals)),
        "yardstick: sparse save": wall(lambda: assemble(
            *(t.cpu().numpy() for t in pairs()))),
        "unpack_oxli_bytes": wall(lambda: unpack_oxli_bytes(spec, raw, dev)),
        "occupied_bins (K13)": wall(lambda: occupied_bins(spec, st.table)),
    }
    log("packing on the loaded table ({} bins, {} nonzero): bytes to the "
        "host {} (the stream) vs {} for the sparse yardstick (8 a pair); "
        "walls (ms, synchronised): {}; calls on the main path: {} [{}]"
        .format(spec.total_bins, hidx.size, raw.size, 8 * hidx.size,
                json.dumps(parts), json.dumps(calls), card))


def device_share(name, fn, card):
    """Run fn once under torch.profiler and print the device's busy time
    (CUDA kernels and copies, summed) against the wall clock.  Returns
    (wall s, busy s), busy None when the profiler saw no CUDA event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: the host ops' events are not read, and on a
    # run of many small ops (phase 7's searches) collecting them took
    # longer than the run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    # the raw kineto events: building prof.events() from them took longer
    # than the run after scripts of many small ops (phase 10's)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + \
                e.duration_ns() / 1e3
    busy = sum(by_name.values()) / 1e6
    if not by_name:
        log("profile {}: wall {:.3f} s; device time not measured (the "
            "profiler saw no CUDA events)".format(name, wall))
        return wall, None
    # the six longest, and every kernel of the port's own
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = top[:6] + [kv for kv in top[6:] if "_kernel" in kv[0] and
                     not any(lib in kv[0] for lib in ("at::", "cub::"))]
    log("profile {}: wall {:.3f} s (profiled), device busy {:.3f} s = "
        "{:.1f}% of the wall, idle {:.1f}% [{}]; by name (ms): {}".format(
            name, wall, busy, 100 * busy / wall, 100 - 100 * busy / wall,
            card, "; ".join("{} {:.3f}".format(n[:48], us / 1e3)
                            for n, us in top)))
    return wall, busy


# ---------------------------------------------------------------------------
# phase 3g: K13 and K14 against their plain versions
# ---------------------------------------------------------------------------


def save_tables(spec, loaded, seed):
    """(name, table) pairs on the loaded table's geometry: the loaded
    table, an empty one, a full one (every bin nonzero, a tenth at or
    above 2**31) and, for each kind, one whose nonzero bins lie one below
    and one above khmer_tpu's sparse-save threshold (random bins and
    values).  Made one at a time on the card."""
    import torch

    from khmer_tpu_torch.ops.sketch_ops import SketchSpec

    n, dev = spec.total_bins, loaded.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def values(m):
        v = torch.randint(1, 1 << 31, (m,), generator=gen, device=dev,
                          dtype=torch.int64)
        big = torch.rand(m, generator=gen, device=dev) < 0.1
        return torch.where(big, -v, v).to(torch.int32)

    yield "loaded", loaded
    yield "empty", torch.zeros_like(loaded)
    full = values(loaded.numel())
    full[-1] = 0
    yield "full", full
    del full
    for kind in ("byte", "nibble", "bit"):
        threshold = SketchSpec(kind, spec.tablesizes).total_bytes // 24
        for side, nz in (("below", threshold - 1), ("above", threshold + 1)):
            t = torch.zeros_like(loaded)
            at = torch.randperm(n, generator=gen, device=dev)[:nz]
            t[at] = values(nz)
            yield "{}-{}".format(side, kind), t
            del t, at


def check_save_kernels(seed, dev, ct, rec):
    """K13 (count_nonzero) and K14 (pack_oxli_bytes) against their plain
    versions on the card, bit for bit, on the tables of save_tables (the
    phase-4 .ct's 4 x ~1e8 bins), K14 in each kind, and on geometries of
    odd sizes; times on the loaded table (K14 in the byte kind, the .ct's
    save, with the nibble and bit kinds beside it)."""
    import torch

    from khmer_tpu_torch import Countgraph, kernels
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.ops.sketch_ops import SketchSpec

    log("phase 3g: K13 and K14 on the phase-4 .ct's table and on empty, "
        "full and threshold tables of its geometry, in each kind")
    g = Countgraph.load(ct, device=dev)
    loaded, spec = g.storage.table, g.storage.spec
    del g
    geom = {kind: SketchSpec(kind, spec.tablesizes) for kind in
            ("byte", "nibble", "bit")}
    sizes, offsets, _ = spec.geometry(dev)
    errs = {"count_nonzero": 0, "pack_oxli_bytes": 0}
    seen = {}

    def compare(table, gsizes, goffsets, tables):
        for lo, hi in ((0, int(tables[0])), (0, table.numel()),
                       (1, table.numel() - 1)):
            errs["count_nonzero"] = max(errs["count_nonzero"], max_abs_err(
                kernels.count_nonzero(table, lo, hi),
                plain.count_nonzero(table, lo, hi)))
        for kind in ("byte", "nibble", "bit"):
            bpt = SketchSpec(kind, tables).bytes_per_table
            errs["pack_oxli_bytes"] = max(
                errs["pack_oxli_bytes"], max_abs_err(
                    kernels.pack_oxli_bytes(table, kind, gsizes, goffsets,
                                            bpt),
                    plain.pack_oxli_bytes(table, kind, gsizes, goffsets,
                                          bpt)))
        return int(plain.count_nonzero(table, 0, sum(tables)))

    for name, table in save_tables(spec, loaded, seed):
        seen[name] = compare(table, sizes, offsets, spec.tablesizes)
        del table
        torch.cuda.empty_cache()
    for tables in ((1009, 1013, 1019), (7,), (9, 16, 17), (3,) * 32):
        small = SketchSpec("byte", tables)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + len(tables))
        t = torch.randint(-(1 << 31), 1 << 31, (small.total_bins + 1,),
                          generator=gen, device=dev, dtype=torch.int64)
        t = torch.where(t % 3 == 0, 0, t).to(torch.int32)
        s_sizes, s_offsets, _ = small.geometry(dev)
        seen["odd {}".format(tables[:3])] = compare(
            t, s_sizes, s_offsets, tables)
    log("K13/K14 inputs, nonzero bins: {}; khmer_tpu's sparse-save "
        "thresholds (pairs): {}".format(json.dumps(seen), json.dumps(
            {k: s.total_bytes // 24 for k, s in geom.items()})))

    n = loaded.numel()
    record_kernel(
        rec, "count_nonzero", errs["count_nonzero"],
        cuda_ms(lambda: kernels.count_nonzero(loaded, 0, n), 10),
        cuda_ms(lambda: plain.count_nonzero(loaded, 0, n), 5), 4 * n,
        library_ms=cuda_ms(lambda: torch.count_nonzero(loaded), 10),
        nonzero=seen["loaded"])
    by_kind = {}
    for kind, ks in geom.items():
        bpt = ks.bytes_per_table
        by_kind[kind] = dict(
            ms=cuda_ms(lambda: kernels.pack_oxli_bytes(
                loaded, kind, sizes, offsets, bpt), 10),
            plain_ms=cuda_ms(lambda: plain.pack_oxli_bytes(
                loaded, kind, sizes, offsets, bpt), 3),
            bound_ms=bound_ms(4 * spec.total_bins + ks.total_bytes))
    byte = by_kind.pop("byte")
    record_kernel(rec, "pack_oxli_bytes", errs["pack_oxli_bytes"],
                  byte["ms"], byte["plain_ms"],
                  4 * spec.total_bins + geom["byte"].total_bytes,
                  kind="byte", other_kinds=by_kind)


# ---------------------------------------------------------------------------
# phase 3b: the slice-2 kernels against their plain versions
# ---------------------------------------------------------------------------


def fixed_records(path, n, width, skip):
    """The first n sequences of a FASTA file of fixed-width records (each
    `width` bytes, the sequence after `skip` header bytes), as str."""
    raw = np.fromfile(path, np.uint8, count=n * width).reshape(n, width)
    return [r.tobytes().decode() for r in raw[:, skip:width - 1]]


def chain_bytes(ids, valid, n_distinct, taken_rows, extra):
    """K6/K7 bound bytes, each input read once and each output written
    once: 1 (valid) a window, 4 (id) a valid window, 2 (pre) a distinct
    k-mer, 1 (real) a row, 4 (tally) a distinct k-mer that a taken
    bundle holds (the others stay the wrapper's zeros), plus the flags
    out (`extra`)."""
    import torch

    lanes = valid.bool()
    tallied = torch.unique(ids[lanes & taken_rows[:, None]]).numel()
    return (ids.numel() + int(lanes.sum()) * 4 + n_distinct * 2 +
            ids.shape[0] + tallied * 4 + extra)


def chain_run(fn, inputs, args):
    """K6 / K7 (`fn`) on one input against its plain version on the card:
    the error, CUDA-event times of both, the rounds and walked bundles the
    kernel took (steps = rounds + walked: each walked bundle is a step of
    its own), and the taken bundles (K6 kept, K7 saved)."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    got = getattr(kernels, fn)(*inputs, *args)
    rounds, walked = kernels.CHAIN_ROUNDS[fn].tolist()
    ref = getattr(plain, fn)(*inputs, *args)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    ms = cuda_ms(lambda: getattr(kernels, fn)(*inputs, *args), 3, inner=1)
    taken = (got[0] != 0) if fn == "diginorm_chain" else got[0] == 2
    del got, ref
    torch.cuda.synchronize()
    return dict(err=err, ms=ms, us_per_bundle=1e3 * ms / BATCH,
                rounds=rounds, walked=walked, steps=rounds + walked,
                bundles_per_step=BATCH / (rounds + walked),
                plain_ms=cuda_ms(lambda: getattr(plain, fn)(*inputs, *args),
                                 1, inner=1, warmup=0),
                taken=taken, n_taken=int(taken.sum()))


def chain_summary(r):
    return {k: r[k] for k in ("err", "ms", "us_per_bundle", "rounds",
                              "walked", "steps", "bundles_per_step",
                              "n_taken")}


def sorted_pairs(seed, n_pairs, stride=10, readlen=100, insert=300):
    """n_pairs read pairs as a file sorted by position holds them: pair j
    starts stride * j bases into a random genome (its /2 mate the reverse
    complement of the fragment's other end, `insert` bases apart), as
    2 n_pairs sequences (str)."""
    genome = np.random.default_rng(seed + 6).integers(
        0, 4, stride * n_pairs + insert, dtype=np.uint8)
    starts = stride * np.arange(n_pairs)
    win = np.arange(readlen)
    r1 = genome[starts[:, None] + win]
    r2 = 3 - genome[(starts + insert - readlen)[:, None] + win][:, ::-1]
    reads = np.frombuffer(b"ACGT", np.uint8)[
        np.stack([r1, r2], 1).reshape(2 * n_pairs, readlen)]
    return [r.tobytes().decode() for r in reads]


def check_slice2_kernels(seed, dev, ct, reads_fa, pairs_fa, rec):
    """K5 on 16,384 bench rows against the phase-4 .ct; K6 and K7 on the
    first batch of the phase-5 file (pre-counts from the phase-4 .ct),
    as it is, with pre all zero, with every 8th bundle repeating the one
    before it and as one bundle repeated, and on pairs sorted by
    position."""
    import torch

    from khmer_tpu_torch import Countgraph, kernels
    from khmer_tpu_torch.hashtable import _batch_ids, _pad_rows
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.ops.hashing import kmer_hashes_2bit

    def record(*args, **kwargs):
        record_kernel(rec, *args, **kwargs)

    cg = Countgraph.load(ct, device=dev)
    st = cg.storage
    geom, cap = st._geom, st.read_cap()
    log("phase 3b: K5 on {} rows of the phase-4 reads, K6 and K7 on the "
        "first {}-bundle batch of the phase-5 file".format(BATCH, BATCH))
    codes, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
        fixed_records(reads_fa, BATCH, 111, 10), K))
    B, L = codes.shape
    W = L - K + 1
    err = 0
    for want in (False, True):
        got = kernels.row_counts(codes, lengths, K, st.table, *geom, cap,
                                 want)
        ref = plain.row_counts(codes, lengths, K, st.table, *geom, cap, want)
        err = max(err, max_abs_err(got[0].to(torch.int32),
                                   ref[0].to(torch.int32)))
        if want:
            err = max(err, max_abs_err(got[1], ref[1]))
            valid = torch.arange(W, device=dev)[None, :] + K <= \
                lengths[:, None]
            distinct = int(torch.unique(got[1][valid]).numel())

    def k1_k3():
        h, _ = kmer_hashes_2bit(codes, lengths, K)
        return kernels.sketch_get(st.table, h.reshape(-1), *geom, cap)

    base = B * L + B * 4 + distinct * st.spec.n_tables * 4
    record("row_counts", err,
           cuda_ms(lambda: kernels.row_counts(codes, lengths, K, st.table,
                                              *geom, cap), 10),
           cuda_ms(lambda: plain.row_counts(codes, lengths, K, st.table,
                                            *geom, cap), 3),
           base + B * W * 2, rows=B, width=L,
           hashes_ms=cuda_ms(lambda: kernels.row_counts(
               codes, lengths, K, st.table, *geom, cap, True), 10),
           hashes_bound_ms=bound_ms(base + B * W * 10),
           k1_k3_ms=cuda_ms(k1_k3, 10))
    del codes, lengths

    codes, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
        fixed_records(pairs_fa, 2 * BATCH, 114, 13), K, min_rows=2))
    h, valid = kmer_hashes_2bit(codes, lengths, K)
    ids, keys = _batch_ids(h, valid)
    valid = valid.to(torch.uint8)
    pre = st.get_lanes(keys)
    real = torch.ones(ids.shape[0], dtype=torch.uint8, device=dev)
    rep_ids, rep_valid = ids.clone(), valid.clone()
    for b in range(1, BATCH, 8):
        rep_ids[2 * b: 2 * b + 2] = rep_ids[2 * b - 2: 2 * b]
        rep_valid[2 * b: 2 * b + 2] = rep_valid[2 * b - 2: 2 * b]
    del h, codes, lengths
    codes, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
        sorted_pairs(seed, BATCH), K, min_rows=2))
    h, s_valid = kmer_hashes_2bit(codes, lengths, K)
    s_ids, s_keys = _batch_ids(h, s_valid)
    s_pre = torch.zeros(s_keys.numel(), dtype=torch.uint16, device=dev)
    del h, codes, lengths, s_keys
    inputs = {  # name: (ids, valid, pre)
        "batch": (ids, valid, pre),
        "fresh": (ids, valid, torch.zeros_like(pre)),
        "repeat8": (rep_ids, rep_valid, pre),
        "sorted": (s_ids, s_valid.to(torch.uint8), s_pre),
        "identical": (ids[:2].repeat(BATCH, 1), valid[:2].repeat(BATCH, 1),
                      pre)}
    calls = (("diginorm_chain", "diginorm_chain", (20,)),
             ("trim_chain", "trim_chain", (18, None, 3)),
             ("trim_chain_dn", "trim_chain", (18, 20, 3)))
    out = {}
    for name, fn, args in calls:
        out[name] = {}
        for inp, (i, v, p) in inputs.items():
            out[name][inp] = chain_run(fn, (i, v, real, p), args)
        if name != "trim_chain_dn":
            # the worst case: identical bundles, every one taken
            i, v, p = inputs["identical"]
            out[name]["identical_all_taken"] = chain_run(
                fn, (i, v, real, p), (65535,) + args[1:])
        got = out[name]["batch"]
        taken = got.pop("taken")
        got["bytes"] = chain_bytes(ids, valid, pre.numel(),
                                   taken.repeat_interleave(2),
                                   BATCH + (8 * BATCH if fn == "trim_chain"
                                            else 0))
        for inp, r in out[name].items():
            r.pop("taken", None)
            log("{} {:20s} err={} ms={:.4f} us_per_bundle={:.4f} rounds={} "
                "walked={} steps={} bundles_per_step={:.2f} plain_ms={:.4f}"
                .format(name, inp, r["err"], r["ms"], r["us_per_bundle"],
                        r["rounds"], r["walked"], r["steps"],
                        r["bundles_per_step"], r["plain_ms"]))
    d = out["diginorm_chain"]
    record("diginorm_chain", max(r["err"] for r in d.values()),
           d["batch"]["ms"], d["batch"]["plain_ms"], d["batch"]["bytes"],
           bundles=BATCH, nw=ids.shape[1], kept=d["batch"]["n_taken"],
           inputs={k: chain_summary(r) for k, r in d.items()})
    t, tdn = out["trim_chain"], out["trim_chain_dn"]
    record("trim_chain",
           max(r["err"] for r in list(t.values()) + list(tdn.values())),
           t["batch"]["ms"], t["batch"]["plain_ms"], t["batch"]["bytes"],
           bundles=BATCH, saved=t["batch"]["n_taken"],
           inputs={k: chain_summary(r) for k, r in t.items()},
           dn_ms=tdn["batch"]["ms"], dn_saved=tdn["batch"]["n_taken"],
           dn_bound_ms=bound_ms(tdn["batch"]["bytes"]),
           dn_inputs={k: chain_summary(r) for k, r in tdn.items()})
    del cg, st, ids, valid, rep_ids, rep_valid, pre, inputs, s_ids, \
        s_valid, s_pre
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the slice-2 path at full width
# ---------------------------------------------------------------------------


def make_pairs(path, seed, n_reads, coverage, genome_mb=3.2, readlen=100,
               insert=300, err=0.005):
    """Interleaved read pairs (/1 forward, /2 the reverse complement of
    the fragment's other end, `insert` bases apart) over the first
    n_reads * readlen / coverage bases of make_reads' genome (the same
    seed draws it), with a share `err` of bases substituted.  Records
    are 114 bytes: '>p' + 8 digits + '/1' or '/2', then the sequence."""
    genome = np.random.default_rng(seed).integers(
        0, 4, int(genome_mb * 1e6), dtype=np.uint8)
    span = min(genome.size, n_reads * readlen // coverage)
    rng = np.random.default_rng(seed + 2)
    n_pairs = n_reads // 2
    starts = rng.integers(0, span - insert, n_pairs)
    win = np.arange(readlen)
    r1 = genome[starts[:, None] + win]
    r2 = 3 - genome[(starts + insert - readlen)[:, None] + win][:, ::-1]
    reads = np.stack([r1, r2], 1).reshape(2 * n_pairs, readlen)
    hit = rng.random(reads.shape, dtype=np.float32) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    rec = np.empty((2 * n_pairs, 14 + readlen), np.uint8)
    rec[:, 0:2] = np.frombuffer(b">p", np.uint8)
    ids = np.repeat(np.arange(n_pairs, dtype=np.int64), 2)
    pows = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    rec[:, 2:10] = (ids[:, None] // pows) % 10 + ord("0")
    rec[:, 10] = ord("/")
    rec[:, 11] = ord("1") + np.arange(2 * n_pairs) % 2
    rec[:, 12] = ord("\n")
    rec[:, 13:13 + readlen] = np.frombuffer(b"ACGT", np.uint8)[reads]
    rec[:, -1] = ord("\n")
    rec.tofile(path)
    return span


def count_records(path):
    """(records, bases) of a FASTA file with one sequence line each."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return len(lines) // 2, sum(len(x) for x in lines[1::2])


def slice2_scripts(workdir, pairs_fa, head_fa, ct, dev, profile, card,
                   names=None):
    """The five slice-2 scripts (or those in `names`) on `dev`, in
    `workdir`; returns their walls (and device busy seconds when
    `profile`), the outputs' sha256, reads and bases written, and the
    n_unique values each script read."""
    from khmer_tpu_torch.hashtable import Hashtable
    from khmer_tpu_torch.scripts import (count_median, filter_abund,
                                         filter_abund_single,
                                         normalize_by_median, trim_low_abund)

    os.makedirs(workdir)
    table = ["-k", str(K), "-N", "4", "-x", repr(TABLE_SIZE)]
    runs = (
        ("normalize-by-median", normalize_by_median.main,
         ["-q"] + table + ["-p", "-C", "20", "--savegraph", "nbm.ct",
                           pairs_fa], ["pairs.fa.keep", "nbm.ct"]),
        ("trim-low-abund", trim_low_abund.main,
         ["-q"] + table + ["-C", "3", "-Z", "18", "-V", pairs_fa],
         ["pairs.fa.abundtrim"]),
        ("filter-abund", filter_abund.main,
         ["-q", "-C", "2", "-o", "filter.fa", ct, pairs_fa], ["filter.fa"]),
        ("filter-abund-single", filter_abund_single.main,
         ["-q"] + table + ["-C", "2", "-o", "single.fa", pairs_fa],
         ["single.fa"]),
        ("count-median", count_median.main,
         [ct, head_fa, "median.csv"], ["median.csv"]))
    runs = tuple(r for r in runs if names is None or r[0] in names)
    n_unique = {}
    counted = Hashtable.n_unique_kmers

    def n_unique_kmers(self):
        n_unique.setdefault(running[-1], []).append(counted(self))
        return n_unique[running[-1]][-1]

    out = {"walls": {}, "busy": {}, "steps": {}}
    running = []

    def timed(method):
        """Hashtable.<method>, its seconds (synchronised on both sides)
        added to out["steps"] under the running script's name."""
        step = getattr(Hashtable, method)

        def run_step(self, *args, **kwargs):
            sync(dev)
            t0 = time.perf_counter()
            got = step(self, *args, **kwargs)
            sync(dev)
            out["steps"][running[-1]] = out["steps"].get(running[-1], 0.0) \
                + time.perf_counter() - t0
            return got
        return run_step

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with mock.patch.object(Hashtable, "n_unique_kmers", n_unique_kmers), \
                mock.patch.object(Hashtable, "diginorm_batch",
                                  timed("diginorm_batch")), \
                mock.patch.object(Hashtable, "trim_pass1_batch",
                                  timed("trim_pass1_batch")):
            for name, fn, argv, outputs in runs:
                running.append(name)
                sync(dev)
                run = lambda: fn(argv, device=dev)  # noqa: E731
                if profile:
                    wall, busy = device_share(name, run, card)
                    out["busy"][name] = busy
                else:
                    t0 = time.perf_counter()
                    run()
                    sync(dev)
                    wall = time.perf_counter() - t0
                out["walls"][name] = wall
                gc.collect()
                for o in outputs:
                    with open(o, "rb") as f:
                        out[o] = hashlib.sha256(f.read()).hexdigest()
                    if not o.endswith((".ct", ".csv")):
                        out[o + " reads,bases"] = count_records(o)
    finally:
        os.chdir(cwd)
    out["n_unique"] = n_unique
    return out


def oracle_first_batch(pairs_fa, ct, dev, C=20):
    """The first batch's keep decisions of normalize-by-median on a table
    loaded from the phase-4 .ct, replayed in numpy as khmer_tpu's
    _drain_host replays them (hashes in numpy, counts before the batch
    from K3, a sequential tally), against Countgraph.diginorm_batch."""
    from khmer_tpu_torch import Countgraph, _u64

    seqs = fixed_records(pairs_fa, 2 * BATCH, 114, 13)
    lut = np.zeros(256, np.uint64)
    for ch, code in ((b"A", 0), (b"T", 1), (b"C", 2), (b"G", 3)):
        lut[ch[0]] = code
    codes = lut[np.frombuffer("".join(seqs).encode(), np.uint8).reshape(
        len(seqs), -1)]
    w = codes.shape[1] - K + 1
    f = np.zeros((len(seqs), w), np.uint64)
    r = np.zeros_like(f)
    for j in range(K):
        c = codes[:, j:j + w]
        f = (f << np.uint64(2)) | c
        r |= (c ^ np.uint64(1)) << np.uint64(2 * j)
    uniq, inv = np.unique(np.minimum(f, r), return_inverse=True)
    inv = inv.reshape(len(seqs), w)
    cg = Countgraph.load(ct, device=dev)
    pre = cg.storage.get_lanes(_u64.as_tensor(uniq, dev)).cpu().numpy()
    pre = pre.astype(np.int64)
    tally = np.zeros(uniq.size, np.int64)
    want = np.zeros(BATCH, np.uint8)
    for b in range(BATCH):
        for row in inv[2 * b: 2 * b + 2]:
            if np.count_nonzero(pre[row] + tally[row] >= C) < (w + 1) // 2:
                want[b] = 1
                break
        if want[b]:
            np.add.at(tally, inv[2 * b: 2 * b + 2].reshape(-1), 1)
    got = cg.diginorm_batch([(seqs[2 * i], seqs[2 * i + 1])
                             for i in range(BATCH)], C).cpu().numpy()
    if not np.array_equal(got, want):
        fail("diginorm_batch's first batch differs from the numpy replay "
             "in {} of {} bundles".format(int((got != want).sum()), BATCH))
    log("numpy replay of the first batch: {} of {} bundles kept, equal to "
        "diginorm_batch on the card".format(int(want.sum()), BATCH))


def make_slice2_files(seed, tmp):
    """The phase-5 file and its first 100,000 reads (count-median's)."""
    pairs_fa = os.path.join(tmp, "pairs.fa")
    head_fa = os.path.join(tmp, "head.fa")
    t0 = time.perf_counter()
    span = make_pairs(pairs_fa, seed, SLICE2_READS, SLICE2_COVERAGE)
    with open(pairs_fa, "rb") as f, open(head_fa, "wb") as g:
        g.write(f.read(100_000 * 114))
    n_bases = SLICE2_READS * 100
    log("phase 5: {} reads of 100 bp in pairs ({} bases, {}x over the "
        "first {} bases of the phase-4 genome, 0.5% substitutions), "
        "{:.1f} s to write".format(SLICE2_READS, n_bases, SLICE2_COVERAGE,
                                   span, time.perf_counter() - t0))
    return pairs_fa, head_fa


def run_slice2(card, dev, tmp, ct, pairs_fa, head_fa):
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    oracle_first_batch(pairs_fa, ct, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = slice2_scripts(os.path.join(tmp, "s2_kernels"), pairs_fa, head_fa,
                         ct, dev, True, card)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("phase 5 launches: {}".format(json.dumps(launches)))
    log("phase 5 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in SLICE2_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the slice-2 path: {}".format(missing))
    for name, wall in got["walls"].items():
        reads = 100_000 if name == "count-median" else SLICE2_READS
        busy = got["busy"].get(name)
        steps = got["steps"].get(name, 0.0)
        log("{}: {:.3f} s (profiled), {:.0f} reads/s, {:.2f} Mbases/s, "
            "device busy {}; inside the batch steps (diginorm_batch / "
            "trim_pass1_batch, synchronised) {:.3f} s = {:.1f}%, the rest "
            "(parsing, pairing, trimming, writing) {:.3f} s [{}]".format(
                name, wall, reads / wall, reads * 100 / wall / 1e6,
                "not measured" if busy is None else
                "{:.3f} s = {:.1f}%".format(busy, 100 * busy / wall),
                steps, 100 * steps / wall, wall - steps, card))
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = slice2_scripts(os.path.join(tmp, "s2_plain"), pairs_fa,
                             head_fa, ct, dev, False, card, SLICE2_PLAIN)
    log("phase 5 plain-version walls (s): {}; inside the batch steps: {} "
        "[{}]".format(json.dumps(ref["walls"]), json.dumps(ref["steps"]),
                      card))
    keys = [k for k in ref if k not in ("walls", "busy", "steps",
                                        "n_unique")]
    for k in keys:
        if got[k] != ref[k]:
            fail("slice-2 path differs from its plain run in {}: {} vs {}"
                 .format(k, got[k], ref[k]))
    for name, values in ref["n_unique"].items():
        if got["n_unique"].get(name) != values:
            fail("slice-2 path differs from its plain run in {}'s "
                 "n_unique".format(name))
    log("kernels == plain on the card ({}): {}".format(
        ", ".join(SLICE2_PLAIN), json.dumps({k: got[k] for k in keys})))
    kept = got["pairs.fa.keep reads,bases"][0]
    if not 0 < kept < SLICE2_READS:
        fail("normalize-by-median kept {} of {} reads".format(
            kept, SLICE2_READS))
    return launches


# ---------------------------------------------------------------------------
# phase 3c: the murmur kernels against their plain versions
# ---------------------------------------------------------------------------


def mixed_bytes(byts, seed, share=0.1):
    """A copy of ASCII rows with a share of their bytes lowercase, N or
    IUPAC."""
    import torch

    rng = np.random.default_rng(seed + 7)
    pool = np.frombuffer(b"acgtNnRYKMSWBDHV", np.uint8)
    out = byts.cpu().numpy().copy()
    hit = rng.random(out.shape) < share
    out[hit] = rng.choice(pool, int(hit.sum()))
    return torch.from_numpy(out).to(byts.device)


def first_chunk(path, k, dev):
    """The first FLAT-base chunk of a file as the native loader cuts it,
    in ASCII on the card, with its window mask."""
    import torch

    from khmer_tpu_torch.hashtable import _CODE_ASCII
    from khmer_tpu_torch.native import NativeChunkReader

    with NativeChunkReader(path, k, FLAT) as reader:
        codes, mask = next(iter(reader))
    codes = torch.from_numpy(codes).to(dev)
    return (_CODE_ASCII.to(dev)[codes.to(torch.int64)],
            torch.from_numpy(mask).to(dev))


def check_murmur_kernels(seed, dev, reads_fa, pairs_fa, rec):
    """K8 on 16,384 phase-5 rows at three k (and with other bytes) and on
    a flat chunk, K5's murmur variant on those rows against a Counttable
    holding their k-mers, K9 on the chunk at two register counts."""
    import torch

    from khmer_tpu_torch import Counttable, kernels
    from khmer_tpu_torch.hashtable import _ascii, _pad_rows
    from khmer_tpu_torch.kernels import plain

    log("phase 3c: K8 on {} phase-5 rows at k = {}, and on a {}-base "
        "chunk of the phase-4 file; K5 (murmur) and K9 (p = {})".format(
            BATCH, MURMUR_KS, FLAT, HLL_PS))
    seqs = fixed_records(pairs_fa, BATCH, 114, 13)
    k8 = {}
    for k in MURMUR_KS:
        byts, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
            seqs, k, encode=_ascii))
        cases = [(form, byts, lengths, acgt) for form, acgt in
                 (("full", False), ("acgt", True))]
        if k == MURMUR_K:
            cases.append(("mixed", mixed_bytes(byts, seed), lengths, False))
            # normalize-by-median -p's batch: BATCH bundles of two mates
            cases.append(("batch",) + tuple(
                torch.from_numpy(a).to(dev) for a in _pad_rows(
                    fixed_records(pairs_fa, 2 * BATCH, 114, 13), k,
                    min_rows=2, encode=_ascii)) + (False,))
        for form, b, lens, acgt in cases:
            B, L = b.shape
            W = L - k + 1
            got = kernels.murmur_hashes(b, lens, k, acgt)
            ref = plain.murmur_hashes(b, lens, k, acgt)
            err = max(max_abs_err(got[0], ref[0]),
                      max_abs_err(got[1], ref[1]))
            del got, ref
            k8["k{}_{}".format(k, form)] = r = dict(
                err=err, rows=B, width=L,
                ms=cuda_ms(lambda: kernels.murmur_hashes(b, lens, k, acgt),
                           10),
                plain_ms=cuda_ms(lambda: plain.murmur_hashes(
                    b, lens, k, acgt), 2, inner=1),
                bound_ms=bound_ms(B * L + B * 4 + B * W * 9))
            log("K8 k={} {:5s} rows {} x {}: err={} ms={:.4f} "
                "plain_ms={:.4f} bound_ms={:.4f}".format(
                    k, form, B, L, err, r["ms"], r["plain_ms"],
                    r["bound_ms"]))
            if err:
                fail("murmur_hashes disagrees with its plain version")
        del cases, b, lens
    # K5's murmur variant on the k = 51 rows, the table holding their k-mers
    byts, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
        seqs, MURMUR_K, encode=_ascii))
    B, L = byts.shape
    W = L - MURMUR_K + 1
    h, valid = kernels.murmur_hashes(byts, lengths, MURMUR_K)
    ct = Counttable(MURMUR_K, TABLE_SIZE, 4, device=dev)
    st = ct.storage
    live = h[valid]
    st.add_lanes(live, torch.ones_like(live, dtype=torch.int32))
    distinct = int(torch.unique(live).numel())
    del h, valid, live
    geom, cap = st._geom, st.read_cap()
    err = 0
    for want in (False, True):
        got = kernels.row_counts(byts, lengths, MURMUR_K, st.table, *geom,
                                 cap, want, "murmur")
        ref = plain.row_counts(byts, lengths, MURMUR_K, st.table, *geom, cap,
                               want, "murmur")
        err = max(err, max_abs_err(got[0].to(torch.int32),
                                   ref[0].to(torch.int32)))
        if want:
            err = max(err, max_abs_err(got[1], ref[1]))
    base = B * L + B * 4 + distinct * st.spec.n_tables * 4
    k5 = dict(
        murmur_err=err, murmur_rows=B, murmur_width=L, murmur_k=MURMUR_K,
        murmur_ms=cuda_ms(lambda: kernels.row_counts(
            byts, lengths, MURMUR_K, st.table, *geom, cap, False, "murmur"),
            10),
        murmur_hashes_ms=cuda_ms(lambda: kernels.row_counts(
            byts, lengths, MURMUR_K, st.table, *geom, cap, True, "murmur"),
            10),
        murmur_plain_ms=cuda_ms(lambda: plain.row_counts(
            byts, lengths, MURMUR_K, st.table, *geom, cap, False, "murmur"),
            2, inner=1),
        murmur_bound_ms=bound_ms(base + B * W * 2),
        murmur_hashes_bound_ms=bound_ms(base + B * W * 10))
    log("K5 murmur k={} rows {} x {}: {}".format(MURMUR_K, B, L, json.dumps(
        k5)))
    if err:
        fail("row_counts (murmur) disagrees with its plain version")
    rec["row_counts"].update(k5)
    rec["row_counts"]["max_abs_err"] = max(rec["row_counts"]["max_abs_err"],
                                           err)
    del ct, st, byts, lengths
    gc.collect()
    torch.cuda.empty_cache()

    # the flat forms on the first chunk of the phase-4 file
    byts, mask = first_chunk(reads_fa, K, dev)
    n = byts.numel()
    one = torch.full((1,), n, dtype=torch.int32, device=dev)
    got = kernels.murmur_hashes(byts[None, :], one, K, True)
    ref = plain.murmur_hashes(byts[None, :], one, K, True)
    err = max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1]))
    del got, ref
    k8["flat"] = dict(
        err=err, bases=n, k=K,
        ms=cuda_ms(lambda: kernels.murmur_hashes(byts[None, :], one, K,
                                                 True), 10),
        plain_ms=cuda_ms(lambda: plain.murmur_hashes(byts[None, :], one, K,
                                                     True), 2, inner=1),
        bound_ms=bound_ms(n + 4 + (n - K + 1) * 9))
    log("K8 flat {} bases k={}: {}".format(n, K, json.dumps(k8["flat"])))
    if err:
        fail("murmur_hashes (flat) disagrees with its plain version")
    main = k8["k{}_batch".format(MURMUR_K)]
    B, L = main["rows"], main["width"]
    record_kernel(rec, "murmur_hashes", max(r["err"] for r in k8.values()),
                  main["ms"], main["plain_ms"],
                  B * L + B * 4 + B * (L - MURMUR_K + 1) * 9, k=MURMUR_K,
                  rows=B, width=L, shapes=k8)
    k9 = {}
    for p in HLL_PS:
        m = 1 << p
        regs = torch.zeros(m, dtype=torch.uint8, device=dev)
        ref = regs.clone()
        kernels.hll_update(byts, mask, K, p, m, regs)
        plain.hll_update(byts, mask, K, p, m, ref)
        k9[p] = dict(err=max_abs_err(regs, ref), bases=n, k=K, registers=m,
                     filled=int((regs != 0).sum()),
                     ms=cuda_ms(lambda: kernels.hll_update(
                         byts, mask, K, p, m, regs), 10),
                     plain_ms=cuda_ms(lambda: plain.hll_update(
                         byts, mask, K, p, m, ref), 2, inner=1),
                     bytes=2 * n + m)
        log("K9 p={}: {}".format(p, json.dumps(k9[p])))
    main = k9[HLL_PS[0]]
    record_kernel(rec, "hll_update", max(r["err"] for r in k9.values()),
                  main["ms"], main["plain_ms"], main["bytes"], p=HLL_PS[0],
                  bases=n, k=K, p16_ms=k9[16]["ms"],
                  p16_plain_ms=k9[16]["plain_ms"],
                  p16_bound_ms=bound_ms(k9[16]["bytes"]))
    del byts, mask
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the murmur path at full size
# ---------------------------------------------------------------------------


def distinct_union(uniq4, pairs_fa, dev, k=K):
    """Distinct canonical k-mers of the phase-4 file (uniq4) together with
    those of the phase-5 file, exactly: exact_kmers' arithmetic in plain
    torch ops on `dev`, then one torch.unique (all fit int64 at k <= 31)."""
    import torch

    raw = np.fromfile(pairs_fa, np.uint8).reshape(-1, 114)[:, 13:113]
    lut = torch.zeros(256, dtype=torch.int64, device=dev)
    for ch, code in ((b"A", 0), (b"T", 1), (b"C", 2), (b"G", 3)):
        lut[ch[0]] = code
    codes = lut[torch.from_numpy(raw.copy()).to(dev).to(torch.int64)]
    w = codes.shape[1] - k + 1
    f = torch.zeros((codes.shape[0], w), dtype=torch.int64, device=dev)
    r = torch.zeros_like(f)
    for j in range(k):
        c = codes[:, j:j + w]
        f <<= 2
        f |= c
        r |= (c ^ 1) << (2 * j)
    keys = torch.cat([torch.from_numpy(uniq4.view(np.int64)).to(dev),
                      torch.minimum(f, r).reshape(-1)])
    del codes, f, r
    return int(torch.unique(keys).numel())


def murmur_scripts(workdir, reads_fa, pairs_fa, dev, profile, card):
    """The phase-6 runs on `dev`, in `workdir`: their walls (and device
    busy seconds when `profile`), the estimates they print, the sha256 of
    every HLL counter's registers when estimated, of the reports and
    output files, reads and bases kept, and the n_unique values read."""
    from khmer_tpu_torch import HLLCounter
    from khmer_tpu_torch.hashtable import Hashtable
    from khmer_tpu_torch.scripts import (filter_abund_single,
                                         normalize_by_median, unique_kmers)

    os.makedirs(workdir)
    table = ["-H", "murmur", "-k", str(MURMUR_K), "-N", "4", "-x",
             repr(TABLE_SIZE)]
    runs = [("unique-kmers -k {}".format(k), unique_kmers.main,
             ["-q", "-k", str(k), "-e", "0.01", "-R", "uk{}.txt".format(k),
              reads_fa, pairs_fa], ["uk{}.txt".format(k)])
            for k in (K, MURMUR_K)]
    runs += [
        ("filter-abund-single -H murmur", filter_abund_single.main,
         ["-q"] + table + ["-C", "2", "-o", "single51.fa", pairs_fa],
         ["single51.fa"]),
        ("normalize-by-median -H murmur", normalize_by_median.main,
         ["-q"] + table + ["-p", "-C", "20", "-o", "nbm51.fa", pairs_fa],
         ["nbm51.fa"])]
    n_unique, registers = [], []
    counted = Hashtable.n_unique_kmers
    estimate = HLLCounter.estimate_cardinality

    def n_unique_kmers(self):
        n_unique.append(counted(self))
        return n_unique[-1]

    def estimate_cardinality(self):
        regs = self._counters[:self._m].cpu().numpy()
        registers.append(hashlib.sha256(regs.tobytes()).hexdigest())
        return estimate(self)

    out = {"walls": {}, "busy": {}}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with mock.patch.object(Hashtable, "n_unique_kmers", n_unique_kmers), \
                mock.patch.object(HLLCounter, "estimate_cardinality",
                                  estimate_cardinality):
            for name, fn, argv, outputs in runs:
                err = io.StringIO()
                run = lambda: fn(argv, device=dev)  # noqa: E731
                sync(dev)
                try:
                    with contextlib.redirect_stderr(err):
                        if profile:
                            wall, busy = device_share(name, run, card)
                            out["busy"][name] = busy
                        else:
                            t0 = time.perf_counter()
                            run()
                            sync(dev)
                            wall = time.perf_counter() - t0
                except BaseException:
                    sys.stderr.write(err.getvalue())
                    raise
                out["walls"][name] = wall
                gc.collect()
                if name.startswith("unique-kmers"):
                    out[name + " estimates"] = [
                        ln for ln in err.getvalue().splitlines()
                        if "unique" in ln and "-mers" in ln]
                for o in outputs:
                    with open(o, "rb") as f:
                        out[o] = hashlib.sha256(f.read()).hexdigest()
                    if o.endswith(".fa"):
                        out[o + " reads,bases"] = count_records(o)
    finally:
        os.chdir(cwd)
    out["n_unique"] = n_unique
    out["registers"] = registers
    return out


def estimate_of(lines, tail):
    """The estimate on the printed line that ends `tail: N`."""
    for ln in lines:
        head, _, value = ln.rpartition(": ")
        if head.endswith(tail):
            return int(value)
    fail("no estimate line ending in {!r}".format(tail))


def run_murmur(card, dev, tmp, reads_fa, pairs_fa, uniq4):
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = murmur_scripts(os.path.join(tmp, "m_kernels"), reads_fa, pairs_fa,
                         dev, True, card)
    launches = dict(kernels.LAUNCHES)
    murmur_rows = kernels.ROW_COUNTS_BY_HASH["murmur"]
    peak = torch.cuda.max_memory_allocated()
    log("phase 6 launches: {}; row_counts by hash: {}".format(
        json.dumps(launches), json.dumps(kernels.ROW_COUNTS_BY_HASH)))
    log("phase 6 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in MURMUR_PATH if launches[k] == 0]
    if missing or not murmur_rows:
        fail("kernels not launched by the murmur path: {}{}".format(
            missing, "" if murmur_rows else " and row_counts (murmur)"))
    for name, wall in got["walls"].items():
        busy = got["busy"].get(name)
        mb = SLICE2_READS * 100 / 1e6 + (64 if name.startswith("unique")
                                          else 0)
        log("{}: {:.3f} s (profiled), {:.2f} Mbases/s, device busy {} "
            "[{}]".format(name, wall, mb / wall,
                          "not measured" if busy is None else
                          "{:.3f} s = {:.1f}%".format(busy,
                                                      100 * busy / wall),
                          card))
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = murmur_scripts(os.path.join(tmp, "m_plain"), reads_fa,
                             pairs_fa, dev, False, card)
    log("phase 6 plain-version walls (s): {} [{}]".format(
        json.dumps(ref["walls"]), card))
    keys = [k for k in got if k not in ("walls", "busy")]
    for k in keys:
        if got[k] != ref[k]:
            fail("murmur path differs from its plain run in {}: {} vs {}"
                 .format(k, got[k], ref[k]))
    log("kernels == plain on the card: {}".format(json.dumps(
        {k: got[k] for k in keys})))
    lines = got["unique-kmers -k {} estimates".format(K)]
    t0 = time.perf_counter()
    exact = {"phase-4 file": int(uniq4.size),
             "total": distinct_union(uniq4, pairs_fa, dev)}
    est = {"phase-4 file": estimate_of(lines, reads_fa),
           "total": estimate_of(lines, "unique {}-mers".format(K))}
    for name in exact:
        rel = est[name] / exact[name] - 1
        log("k = {} estimate, {}: {} against exactly {} distinct ({:+.3%}; "
            "exact counts {:.1f} s)".format(
                K, name, est[name], exact[name], rel,
                time.perf_counter() - t0))
        if abs(rel) > 0.03:
            fail("the {} estimate is not within 3% of the exact count"
                 .format(name))
    kept = got["nbm51.fa reads,bases"][0]
    if not 0 < kept < SLICE2_READS:
        fail("normalize-by-median -H murmur kept {} of {} reads".format(
            kept, SLICE2_READS))
    launches["row_counts_murmur"] = murmur_rows
    return launches


# ---------------------------------------------------------------------------
# phase 7: tag-based partitioning at full width
# ---------------------------------------------------------------------------


def make_metagenome(path, seed, n_genomes, n_reads, readlen=100, err=0.005):
    """A metagenome's reads: n_genomes random genomes of 1-8 kbases, reads
    of `readlen` bases drawn over them in proportion to their length, a
    share `err` of bases substituted and half of the reads
    reverse-complemented.  Records are 112 bytes: '>m' + 8 digits, then
    the sequence.  Returns the bases of all genomes."""
    rng = np.random.default_rng(seed + 3)
    lens = rng.integers(1000, 8001, n_genomes)
    offs = np.concatenate([[0], np.cumsum(lens)])
    genome = rng.integers(0, 4, int(offs[-1]), dtype=np.uint8)
    starts = lens - readlen + 1
    which = rng.choice(n_genomes, n_reads, p=starts / starts.sum())
    at = offs[which] + (rng.random(n_reads) * starts[which]).astype(np.int64)
    reads = genome[at[:, None] + np.arange(readlen)]
    hit = rng.random(reads.shape, dtype=np.float32) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    rec = np.empty((n_reads, 12 + readlen), np.uint8)
    rec[:, 0:2] = np.frombuffer(b">m", np.uint8)
    pows = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    rec[:, 2:10] = (np.arange(n_reads)[:, None] // pows) % 10 + ord("0")
    rec[:, 10] = ord("\n")
    rec[:, 11:11 + readlen] = np.frombuffer(b"ACGT", np.uint8)[reads]
    rec[:, -1] = ord("\n")
    rec.tofile(path)
    return int(offs[-1])


def partition_scripts(workdir, fa, dev, profile, card):
    """The documented partitioning workflow on `dev`, in `workdir`
    (docs/user/partitioning-big-data.md, with the table cut to -x 1e8):
    load-graph, partition-graph (and a second run with --no-big-traverse
    on a copy of the graph, base gn), merge-partitions of both,
    annotate-partitions and extract-partitions.  Returns the walls (and
    device busy seconds when `profile`) and, after each script, the
    sha256 of every file in workdir."""
    import shutil

    from khmer_tpu_torch.scripts import (annotate_partitions,
                                         extract_partitions, load_graph,
                                         merge_partitions, partition_graph)

    os.makedirs(workdir)
    runs = [("load-graph", load_graph.main,
             ["-k", str(PARTITION_K), "-N", "4", "-x", repr(TABLE_SIZE),
              "g", fa]),
            ("partition-graph", partition_graph.main, ["-s", "1e5", "g"]),
            ("partition-graph --no-big-traverse", partition_graph.main,
             ["--no-big-traverse", "-s", "1e5", "gn"]),
            ("merge-partitions", merge_partitions.main, ["g"]),
            ("merge-partitions (gn)", merge_partitions.main, ["gn"]),
            ("annotate-partitions", annotate_partitions.main, ["g", fa]),
            ("extract-partitions", extract_partitions.main,
             ["g", os.path.basename(fa) + ".part"])]
    out = {"walls": {}, "busy": {}, "files": {}}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for name, fn, argv in runs:
            if name == "partition-graph --no-big-traverse":
                shutil.copy("g", "gn")
                shutil.copy("g.tagset", "gn.tagset")
            err = io.StringIO()
            run = lambda: fn(argv, device=dev)  # noqa: E731
            sync(dev)
            try:
                with contextlib.redirect_stderr(err):
                    if profile:
                        wall, busy = device_share(name, run, card)
                        out["busy"][name] = busy
                    else:
                        t0 = time.perf_counter()
                        run()
                        sync(dev)
                        wall = time.perf_counter() - t0
            except BaseException:
                sys.stderr.write(err.getvalue()[-20000:])
                raise
            out["walls"][name] = wall
            log("phase 7 {} done, {:.1f} s into the smoke".format(
                name, time.perf_counter() - STARTED))
            out["files"][name] = {}
            for f in sorted(os.listdir(".")):
                with open(f, "rb") as fh:
                    out["files"][name][f] = hashlib.sha256(
                        fh.read()).hexdigest()
            gc.collect()
        out["sizes"] = {f: os.path.getsize(f) for f in sorted(os.listdir("."))}
    finally:
        os.chdir(cwd)
    return out


def partition_sets(subset):
    """A SubsetPartition's partitions as a set of frozensets of tags."""
    by_pid = {}
    for tag, pid in subset.partition_map.items():
        if pid is not None:
            by_pid.setdefault(pid, set()).add(tag)
    return {frozenset(t) for t in by_pid.values()}


def device_engine(graph_base, dev, card):
    """do_partition_device (the star edges' components by K10) and
    do_partition (the host union) on the loaded phase-7 graph: their
    partitions as sets must agree.  Returns the star edge list K10 was
    given (n, src, dst) and the engine's numbers."""
    from khmer_tpu_torch import Nodegraph, SubsetPartition, partition_device
    from khmer_tpu_torch.kernels import CC_BLOCK

    ng = Nodegraph.load(graph_base, device=dev)
    ng.load_tagset(graph_base + ".tagset")
    star = {}
    components = partition_device.connected_components

    def keep_edges(n, src, dst, *args, **kwargs):
        star.update(n=n, src=src, dst=dst)
        return components(n, src, dst, *args, **kwargs)

    sync(dev)
    t0 = time.perf_counter()
    with mock.patch.object(partition_device, "connected_components",
                           keep_edges):
        on_card = SubsetPartition(ng)
        on_card.do_partition_device()
    sync(dev)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = SubsetPartition(ng)
    host.do_partition()
    t_host = time.perf_counter() - t0
    sets = partition_sets(host)
    if partition_sets(on_card) != sets or \
            on_card.count_partitions() != host.count_partitions():
        fail("do_partition_device's partitions differ from do_partition's")
    st = on_card.device_stats
    info = dict(tags=st["tags"], edges=st["edges"],
                cc_calls=st["calls"], cc_rounds=CC_BLOCK * st["calls"],
                partitions=len(sets),
                unassigned=host.count_partitions()[1],
                do_partition_device_s=t_dev, do_partition_s=t_host)
    log("phase 7 device engine: do_partition_device == do_partition as "
        "sets of tags: {} [{}]".format(json.dumps(info), card))
    return (star["n"], star["src"], star["dst"]), info


def run_partition(card, dev, tmp, seed):
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    wd = os.path.join(tmp, "p7")
    os.makedirs(wd)
    fa = os.path.join(wd, "reads.fa")
    t0 = time.perf_counter()
    bases = make_metagenome(fa, seed, PARTITION_GENOMES, PARTITION_READS)
    log("phase 7: {} reads of 100 bp over {} random genomes of 1-8 kbases "
        "({} bases, {:.2f}x), 0.5% substitutions, half reverse-"
        "complemented, {:.1f} s to write".format(
            PARTITION_READS, PARTITION_GENOMES, bases,
            PARTITION_READS * 100 / bases, time.perf_counter() - t0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = partition_scripts(os.path.join(wd, "kernels"), fa, dev, True,
                            card)
    star, info = device_engine(os.path.join(wd, "kernels", "g"), dev, card)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("phase 7 launches: {}".format(json.dumps(launches)))
    log("phase 7 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in PARTITION_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the partitioning path: {}".format(
            missing))
    for name, wall in got["walls"].items():
        busy = got["busy"].get(name)
        log("{}: {:.3f} s (profiled), {:.0f} reads/s, device busy {} "
            "[{}]".format(name, wall, PARTITION_READS / wall,
                          "not measured" if busy is None else
                          "{:.3f} s = {:.1f}%".format(busy,
                                                      100 * busy / wall),
                          card))
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = partition_scripts(os.path.join(wd, "plain"), fa, dev, False,
                                card)
    log("phase 7 plain-version walls (s): {} [{}]".format(
        json.dumps(ref["walls"]), card))
    if got["files"] != ref["files"]:
        bad = sorted("{}: {}".format(step, f)
                     for step, files in got["files"].items()
                     for f in set(files) | set(ref["files"][step])
                     if files.get(f) != ref["files"][step].get(f))
        fail("partitioning path differs from its plain run in " +
             "; ".join(bad[:10]))
    final = got["files"]["extract-partitions"]
    subsets = sorted(f for f in got["files"]["partition-graph"]
                     if f.startswith("g.subset."))
    groups = [f for f in final if ".group" in f]
    log("kernels == plain on the card: every file after every script "
        "({} files at the end: {}; {} subset pmaps; {} group files); "
        "sizes {}".format(len(final), ", ".join(sorted(final)),
                          len(subsets), len(groups),
                          json.dumps(got["sizes"])))
    if len(subsets) < 2 or not groups:
        fail("phase 7 made {} subset pmaps and {} group files".format(
            len(subsets), len(groups)))
    return launches, star, info


# ---------------------------------------------------------------------------
# phase 3d: K10 against its plain version
# ---------------------------------------------------------------------------


def cc_inputs(seed, dev, star, n=1 << 22, e=1 << 24):
    """K10's three inputs as (T, int32 src, int32 dst) on the card: a
    path of n nodes; a random graph of n nodes and e edges, an eighth of
    them copies of others and an eighth padding (0, 0), shuffled; and
    phase 7's star edge list (the tensors do_partition_device gave
    connected_components)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 10)
    path = torch.arange(n - 1, dtype=torch.int32, device=dev)
    src = torch.randint(0, n, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=g, device=dev,
                        dtype=torch.int32)
    eighth = e // 8
    pick = torch.randint(0, e - 2 * eighth, (eighth,), generator=g,
                         device=dev)
    src[e - 2 * eighth: e - eighth] = src[pick]
    dst[e - 2 * eighth: e - eighth] = dst[pick]
    src[e - eighth:] = 0
    dst[e - eighth:] = 0
    perm = torch.randperm(e, generator=g, device=dev)
    T, s7, d7 = star
    return {"path": (n, path, path + 1),
            "random": (n, src[perm].contiguous(), dst[perm].contiguous()),
            "phase-7 star": (T, s7.to(dev, torch.int32).contiguous(),
                             d7.to(dev, torch.int32).contiguous())}


def check_cc_kernel(seed, dev, rec, star):
    """K10 against its plain version on the card, exactly: labels and the
    changed flag from arange labels at rounds = 1 and CC_BLOCK (8), and
    the labels at the fixpoint of connected_components (and its number of
    calls); CUDA-event times a call at rounds = CC_BLOCK (the path's call)
    and 1."""
    import torch

    from khmer_tpu_torch import kernels, partition_device
    from khmer_tpu_torch.kernels import plain

    block = kernels.CC_BLOCK

    log("phase 3d: K10 on a 2**22-node path, a 2**22-node graph of 2**24 "
        "random edges (an eighth repeated, an eighth padding) and phase "
        "7's star edge list")
    out = {}
    for name, (T, src, dst) in cc_inputs(seed, dev, star).items():
        lab = torch.arange(T, dtype=torch.int32, device=dev)
        err = 0
        for rounds in (1, block):
            got = kernels.cc_rounds(lab, src, dst, rounds)
            want = plain.cc_rounds(lab, src, dst, rounds)
            err = max(err, max_abs_err(got[0], want[0]),
                      int(bool(got[1]) != bool(want[1])))
        fix = {}
        for side, fn in (("kernel", kernels.cc_rounds),
                         ("plain", plain.cc_rounds)):
            stats = {}
            with mock.patch.object(kernels, "cc_rounds", fn):
                labels = partition_device.connected_components(
                    T, src.cpu().numpy().view(np.uint32),
                    dst.cpu().numpy().view(np.uint32), dev, stats=stats)
            fix[side] = (labels, stats["calls"])
        err = max(err, max_abs_err(fix["kernel"][0], fix["plain"][0]),
                  int(fix["kernel"][1] != fix["plain"][1]))
        E = src.numel()
        r = dict(T=T, E=E, err=err, calls=fix["kernel"][1],
                 components=int(torch.unique(fix["kernel"][0]).numel()),
                 ms=cuda_ms(lambda: kernels.cc_rounds(lab, src, dst, block),
                            10),
                 ms_1=cuda_ms(lambda: kernels.cc_rounds(lab, src, dst, 1),
                              10),
                 plain_ms=cuda_ms(
                     lambda: plain.cc_rounds(lab, src, dst, block), 3),
                 bytes=8 * E + 8 * T)
        log("K10 {}: T {} E {}; max_abs_err {}; {} calls of {} rounds to "
            "the fixpoint, {} components; {:.4f} ms a call of {} rounds, "
            "{:.4f} of 1; plain {:.4f}; bound {:.4f} ms ({} bytes)".format(
                name, T, E, err, r["calls"], block, r["components"], r["ms"],
                block,
                r["ms_1"], r["plain_ms"], bound_ms(r["bytes"]),
                r["bytes"]))
        out[name] = r
        del lab
        gc.collect()
    star_run = out["phase-7 star"]
    record_kernel(
        rec, "cc_rounds", max(r["err"] for r in out.values()),
        star_run["ms"], star_run["plain_ms"], star_run["bytes"],
        **{"{}_{}".format(name.replace(" ", "_").replace("-", ""), key):
           r[key] for name, r in out.items()
           for key in ("T", "E", "ms", "ms_1", "plain_ms", "calls")})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3e: the slice-3b kernels against their plain versions
# ---------------------------------------------------------------------------


def check_cyclic_kernels(seed, dev, reads_fa, pairs_fa, rec):
    """K11 on 16,384 phase-5 rows at CYCLIC_KS (and with other bytes) and
    on the flat chunk phase 8 hashes, K5c on the rows at k = 20 and 51
    against a CyclicCounttable holding their k-mers.  Library time: none,
    no PyTorch call computes this hash."""
    import torch

    from khmer_tpu_torch import CyclicCounttable, kernels
    from khmer_tpu_torch.hashtable import _ascii, _pad_rows
    from khmer_tpu_torch.kernels import plain

    log("phase 3e: K11 on {} phase-5 rows at k = {} and on a {}-base chunk "
        "of the phase-4 file; K5c at k = {} and {}".format(
            BATCH, CYCLIC_KS, FLAT, K, MURMUR_K))
    seqs = fixed_records(pairs_fa, BATCH, 114, 13)
    k11 = {}
    for k in CYCLIC_KS:
        byts, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
            seqs, k, encode=_ascii))
        cases = [("rows", byts)]
        if k == MURMUR_K:
            cases.append(("mixed", mixed_bytes(byts, seed)))
        for form, b in cases:
            B, L = b.shape
            W = L - k + 1
            got = kernels.cyclic_hashes(b, lengths, k)
            ref = plain.cyclic_hashes(b, lengths, k)
            err = max(max_abs_err(got[0], ref[0]),
                      max_abs_err(got[1], ref[1]))
            del got, ref
            k11["k{}_{}".format(k, form)] = r = dict(
                err=err, rows=B, width=L,
                ms=cuda_ms(lambda: kernels.cyclic_hashes(b, lengths, k), 10),
                plain_ms=cuda_ms(lambda: plain.cyclic_hashes(b, lengths, k),
                                 2, inner=1),
                bound_ms=bound_ms(B * L + B * 4 + B * W * 9))
            log("K11 k={} {:5s} rows {} x {}: err={} ms={:.4f} "
                "plain_ms={:.4f} bound_ms={:.4f}".format(
                    k, form, B, L, err, r["ms"], r["plain_ms"],
                    r["bound_ms"]))
            if err:
                fail("cyclic_hashes disagrees with its plain version")
        del cases, b, byts, lengths
    # K5c at phase 8's k and at 51, the table holding the rows' k-mers
    k5c = {}
    for k in (K, MURMUR_K):
        byts, lengths = (torch.from_numpy(a).to(dev) for a in _pad_rows(
            seqs, k, encode=_ascii))
        B, L = byts.shape
        W = L - k + 1
        h, valid = kernels.cyclic_hashes(byts, lengths, k)
        ct = CyclicCounttable(k, TABLE_SIZE, 4, device=dev)
        st = ct.storage
        live = h[valid]
        st.add_lanes(live, torch.ones_like(live, dtype=torch.int32))
        distinct = int(torch.unique(live).numel())
        del h, valid, live
        geom, cap = st._geom, st.read_cap()
        err = 0
        for want in (False, True):
            got = kernels.row_counts(byts, lengths, k, st.table, *geom, cap,
                                     want, "cyclic")
            ref = plain.row_counts(byts, lengths, k, st.table, *geom, cap,
                                   want, "cyclic")
            err = max(err, max_abs_err(got[0].to(torch.int32),
                                       ref[0].to(torch.int32)))
            if want:
                err = max(err, max_abs_err(got[1], ref[1]))
        del got, ref
        base = B * L + B * 4 + distinct * st.spec.n_tables * 4
        k5c[k] = r = dict(
            err=err, rows=B, width=L, k=k, distinct=distinct,
            ms=cuda_ms(lambda: kernels.row_counts(
                byts, lengths, k, st.table, *geom, cap, False, "cyclic"),
                10),
            hashes_ms=cuda_ms(lambda: kernels.row_counts(
                byts, lengths, k, st.table, *geom, cap, True, "cyclic"), 10),
            plain_ms=cuda_ms(lambda: plain.row_counts(
                byts, lengths, k, st.table, *geom, cap, True, "cyclic"),
                2, inner=1),
            bytes=base + B * W * 10, counts_bound_ms=bound_ms(
                base + B * W * 2))
        log("K5c k={} rows {} x {}: {}".format(k, B, L, json.dumps(r)))
        if err:
            fail("row_counts (cyclic) disagrees with its plain version")
        del ct, st, byts, lengths
        gc.collect()
        torch.cuda.empty_cache()
    # phase 8's call: get_median_count_batch reads counts and hashes
    main = k5c[K]
    record_kernel(rec, "row_counts_cyclic",
                  max(r["err"] for r in k5c.values()), main["hashes_ms"],
                  main["plain_ms"], main["bytes"], k=K, rows=main["rows"],
                  width=main["width"], counts_only_ms=main["ms"],
                  counts_only_bound_ms=main["counts_bound_ms"],
                  **{"k{}_{}".format(MURMUR_K, key): v
                     for key, v in k5c[MURMUR_K].items()
                     if key in ("ms", "hashes_ms", "plain_ms", "err")})

    # the flat form on the first chunk of the phase-4 file: phase 8's
    # consume_seqfile and abundance_distribution hash such chunks
    byts, _ = first_chunk(reads_fa, K, dev)
    n = byts.numel()
    one = torch.full((1,), n, dtype=torch.int32, device=dev)
    got = kernels.cyclic_hashes(byts[None, :], one, K)
    ref = plain.cyclic_hashes(byts[None, :], one, K)
    err = max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1]))
    del got, ref
    k11["flat"] = r = dict(
        err=err, bases=n, k=K,
        ms=cuda_ms(lambda: kernels.cyclic_hashes(byts[None, :], one, K), 10),
        plain_ms=cuda_ms(lambda: plain.cyclic_hashes(byts[None, :], one, K),
                         2, inner=1),
        bytes=n + 4 + (n - K + 1) * 9)
    log("K11 flat {} bases k={}: {}".format(n, K, json.dumps(r)))
    if err:
        fail("cyclic_hashes (flat) disagrees with its plain version")
    record_kernel(rec, "cyclic_hashes", max(v["err"] for v in k11.values()),
                  r["ms"], r["plain_ms"], r["bytes"], k=K, bases=n,
                  shapes={key: v for key, v in k11.items() if key != "flat"})
    del byts
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: slice 3b, the 4-bit tables and the cyclic hash, at full width
# ---------------------------------------------------------------------------


def ct_tables(path):
    """(k, occupied, per-table uint8 bins) of an OXLI count file
    (SAVED_COUNTING_HT = 1 or SAVED_SMALLCOUNT = 7), read with numpy
    alone: a byte table holds one bin a byte, a small one two (the even
    bin in the high nibble) and a pad nibble, which must be 0."""
    raw = np.fromfile(path, np.uint8)
    ht_type = int(raw[5])
    if raw[:4].tobytes() != b"OXLI" or ht_type not in (1, 7):
        fail("{} is not an OXLI count file".format(path))
    off = 6 + (ht_type == 1)  # a byte table's bigcount flag
    ksize, n_tables, occupied = struct.unpack_from("<IBQ", raw, off)
    off += 13
    tables = []
    for _ in range(n_tables):
        (size,) = struct.unpack_from("<Q", raw, off)
        off += 8
        nbytes = size if ht_type == 1 else size // 2 + 1
        b = raw[off: off + nbytes]
        off += nbytes
        if ht_type == 7:
            pair = np.stack([b >> 4, b & 15], 1).reshape(-1)
            if pair[size:].any():
                fail("{}: a pad nibble is not 0".format(path))
            b = pair[:size]
        tables.append(b)
    return ksize, occupied, tables


def hist_rows(csv):
    """{abundance: count} of the nonzero rows of an abundance-dist CSV."""
    out = {}
    for line in csv.splitlines()[1:]:
        a, c = line.split(b",")[:2]
        if int(c):
            out[int(a)] = int(c)
    return out


def cyclic_table_run(reads_fa, pairs_fa, dev):
    """CyclicCounttable(20, 1e8, 4) on `dev`, in the working directory:
    consume_seqfile and abundance_distribution of the phase-4 file,
    get_median_count_batch of the first 16,384 phase-5 reads (K5c), save,
    load and save again.  Returns what it read and the saved files'
    sha256."""
    from khmer_tpu_torch import CyclicCounttable, Nodetable

    ct = CyclicCounttable(K, TABLE_SIZE, 4, device=dev)
    ct.consume_seqfile(reads_fa)
    out = {"cyclic n_unique": ct.n_unique_kmers()}
    hist = ct.abundance_distribution(
        reads_fa, Nodetable(K, 1, 1, primes=ct.hashsizes(), device=dev))
    out["cyclic histogram"] = hashlib.sha256(
        np.array(hist, np.int64).tobytes()).hexdigest()
    out["cyclic histogram total"] = int(sum(hist))
    medians = ct.get_median_count_batch(fixed_records(pairs_fa, BATCH, 114,
                                                      13))
    out["cyclic medians"] = hashlib.sha256(json.dumps(medians).encode()) \
        .hexdigest()
    ct.save("cyclic.ct")
    del ct
    CyclicCounttable.load("cyclic.ct", device=dev).save("cyclic_again.ct")
    for name in ("cyclic.ct", "cyclic_again.ct"):
        with open(name, "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def small_count_runs(workdir, reads_fa, eighth_fa, pairs_fa, dev, profile,
                     card):
    """Phase 8's runs on `dev`, in `workdir`: their walls (and device busy
    seconds when `profile`), every output file's sha256, reads and bases
    written, the n_unique values read and the cyclic table's results."""
    from khmer_tpu_torch.hashtable import Hashtable
    from khmer_tpu_torch.scripts import (abundance_dist_single,
                                         filter_abund_single,
                                         load_into_counting,
                                         normalize_by_median, trim_low_abund)

    os.makedirs(workdir)
    table = ["-q", "--small-count", "-k", str(K), "-N", "4", "-x",
             repr(TABLE_SIZE)]
    runs = [
        ("load-into-counting --small-count", load_into_counting.main,
         table + ["small.ct", reads_fa], ["small.ct"]),
        ("abundance-dist-single --small-count", abundance_dist_single.main,
         table + [reads_fa, "small.hist"], ["small.hist"]),
        ("normalize-by-median --small-count", normalize_by_median.main,
         table + ["-p", "-C", "20", "--savegraph", "nbm.ct", "-o", "nbm.fa",
                  eighth_fa], ["nbm.fa", "nbm.ct"]),
        ("filter-abund-single --small-count", filter_abund_single.main,
         table + ["-C", "2", "-o", "single.fa", eighth_fa], ["single.fa"]),
        ("trim-low-abund --small-count", trim_low_abund.main,
         table + ["-C", "3", "-Z", "18", "-V", "-o", "trim.fa", eighth_fa],
         ["trim.fa"]),
        ("trim-low-abund --small-count --loadgraph", trim_low_abund.main,
         ["-q", "--small-count", "--loadgraph", "small.ct", "-C", "3", "-Z",
          "18", "-V", "-o", "trimlg.fa", eighth_fa], ["trimlg.fa"]),
    ]
    n_unique = []
    counted = Hashtable.n_unique_kmers

    def n_unique_kmers(self):
        n_unique.append(counted(self))
        return n_unique[-1]

    out = {"walls": {}, "busy": {}}
    cwd = os.getcwd()
    os.chdir(workdir)

    def timed(name, run):
        sync(dev)
        if profile:
            wall, busy = device_share(name, run, card)
            out["busy"][name] = busy
        else:
            t0 = time.perf_counter()
            run()
            sync(dev)
            wall = time.perf_counter() - t0
        out["walls"][name] = wall
        gc.collect()

    try:
        with mock.patch.object(Hashtable, "n_unique_kmers", n_unique_kmers):
            for name, fn, argv, outputs in runs:
                timed(name, lambda: fn(argv, device=dev))
                for o in outputs:
                    with open(o, "rb") as f:
                        out[o] = hashlib.sha256(f.read()).hexdigest()
                    if o.endswith(".fa"):
                        out[o + " reads,bases"] = count_records(o)
            got = {}
            timed("CyclicCounttable", lambda: got.update(cyclic_table_run(
                reads_fa, pairs_fa, dev)))
            out.update(got)
    finally:
        os.chdir(cwd)
    out["n_unique"] = n_unique
    return out


def run_small_count(card, dev, tmp, reads_fa, pairs_fa, uniq4):
    """Phase 8: the runs through the kernels (profiled) and through the
    plain versions, then checks (a)-(e).  Returns the path's launches."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.primes import get_n_primes_near_x

    eighth_fa = os.path.join(tmp, "eighth.fa")
    with open(pairs_fa, "rb") as f, open(eighth_fa, "wb") as g:
        g.write(f.read(SMALL_READS * 114))
    log("phase 8: --small-count scripts on the phase-4 file and on the "
        "first {} reads of the phase-5 file; a CyclicCounttable on the "
        "phase-4 file".format(SMALL_READS))
    t_phase = time.perf_counter()
    # K3 launches by read cap
    k3_caps = {}
    k3 = kernels.sketch_get

    def sketch_get(table, hashes, sizes, offsets, recips, cap):
        before = kernels.LAUNCHES["sketch_get"]
        got = k3(table, hashes, sizes, offsets, recips, cap)
        k3_caps[int(cap)] = k3_caps.get(int(cap), 0) + \
            kernels.LAUNCHES["sketch_get"] - before
        return got

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with mock.patch.object(kernels, "sketch_get", sketch_get):
        got = small_count_runs(os.path.join(tmp, "s3b_kernels"), reads_fa,
                               eighth_fa, pairs_fa, dev, True, card)
    launches = dict(kernels.LAUNCHES)
    by_hash = dict(kernels.ROW_COUNTS_BY_HASH)
    peak = torch.cuda.max_memory_allocated()
    log("phase 8 launches: {}; row_counts by hash: {}; K3 by read cap: {}"
        .format(json.dumps(launches), json.dumps(by_hash),
                json.dumps(k3_caps)))
    log("phase 8 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in SMALL_PATH if launches[k] == 0]
    if missing or not by_hash["cyclic"] or not k3_caps.get(NIBBLE_CAP):
        fail("(e) kernels not launched by the slice-3b path: {}{}{}".format(
            missing, "" if by_hash["cyclic"] else " and K5c",
            "" if k3_caps.get(NIBBLE_CAP) else " and K3 at cap 15"))
    for name, wall in got["walls"].items():
        reads = 640_000 if "counting" in name or "dist" in name or \
            name == "CyclicCounttable" else SMALL_READS
        busy = got["busy"].get(name)
        log("{}: {:.3f} s (profiled), {:.0f} reads/s, device busy {} [{}]"
            .format(name, wall, reads / wall,
                    "not measured" if busy is None else
                    "{:.3f} s = {:.1f}%".format(busy, 100 * busy / wall),
                    card))
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = small_count_runs(os.path.join(tmp, "s3b_plain"), reads_fa,
                               eighth_fa, pairs_fa, dev, False, card)
    log("phase 8 plain-version walls (s): {} [{}]".format(
        json.dumps(ref["walls"]), card))
    keys = [k for k in got if k not in ("walls", "busy")]
    for k in keys:
        if got[k] != ref[k]:
            fail("(a) slice-3b path differs from its plain run in {}: {} vs "
                 "{}".format(k, got[k], ref[k]))
    log("(a) kernels == plain on the card: {}".format(json.dumps(
        {k: got[k] for k in keys})))
    if got["cyclic.ct"] != got["cyclic_again.ct"]:
        fail("(a) the loaded cyclic table saves other bytes")

    # (b) the small .ct against phase 4's byte .ct
    k4, occ4, byte_bins = ct_tables(os.path.join(tmp, "kernels", "reads.ct"))
    ks, occs, small_bins = ct_tables(os.path.join(tmp, "s3b_kernels",
                                                  "small.ct"))
    if (ks, occs) != (k4, occ4) or len(small_bins) != len(byte_bins) or any(
            not np.array_equal(a, np.minimum(b, NIBBLE_CAP))
            for a, b in zip(small_bins, byte_bins)):
        fail("(b) the small .ct is not min(phase-4 bins, 15)")
    at_cap = int(sum(int((a == NIBBLE_CAP).sum()) for a in small_bins))
    log("(b) small .ct bins == min(phase-4 .ct bins, 15): {} tables, {} "
        "occupied, {} bins at 15".format(len(small_bins), occs, at_cap))
    # (c) the folded histogram
    with open(os.path.join(tmp, "kernels", "single.hist"), "rb") as f:
        full = hist_rows(f.read())
    with open(os.path.join(tmp, "s3b_kernels", "small.hist"), "rb") as f:
        small = hist_rows(f.read())
    folded = {}
    for a, c in full.items():
        folded[min(a, NIBBLE_CAP)] = folded.get(min(a, NIBBLE_CAP), 0) + c
    if small != folded:
        fail("(c) the --small-count histogram is not phase 4's folded at 15")
    log("(c) --small-count histogram == phase 4's folded at 15: {} rows, "
        "{} k-mers at 15".format(len(small), small.get(NIBBLE_CAP, 0)))
    # (d) the cyclic n_unique against the exact distinct count
    distinct = int(uniq4.size)
    occ = 1.0 - math.exp(-distinct / min(get_n_primes_near_x(4, TABLE_SIZE)))
    bound = int(math.ceil(10 * distinct * occ ** 4)) + 10
    nu = got["cyclic n_unique"]
    log("(d) cyclic n_unique {} against {} distinct canonical k-mers "
        "(collision bound {}); histogram total {}".format(
            nu, distinct, bound, got["cyclic histogram total"]))
    if not 0 <= distinct - nu <= bound:
        fail("(d) cyclic n_unique {} is not within {} below the exact {}"
             .format(nu, bound, distinct))
    kept = got["nbm.fa reads,bases"][0]
    if not 0 < kept <= SMALL_READS:
        fail("normalize-by-median --small-count kept {} of {} reads".format(
            kept, SMALL_READS))
    log("phase 8: {:.1f} s with its plain run and checks [{}]".format(
        time.perf_counter() - t_phase, card))
    launches["row_counts_cyclic"] = by_hash["cyclic"]
    return launches


# ---------------------------------------------------------------------------
# phase 3f: K12 against its plain version
# ---------------------------------------------------------------------------


def check_filter_kernel(dev, reads_fa, ct, rec):
    """K12 on the first chunk of the phase-4 file (K1 lanes and K8 lanes
    of the same bases) against its plain version: band only, mask only
    (the phase-4 .ct's table at its cap and at cap 1, as a Nodegraph is
    read; thresholds 0 and 5, consume_masked both ways), both, and the
    crafted hashes at the band edges; CUDA-event times beside K3 on the
    same keys.  bytes: 8 (hash) + 4 (weight) read and 4 written a lane,
    and with a mask the T bins of each distinct hash that reaches the
    gather.  Library time: none, no PyTorch call computes the filter and
    its total."""
    import torch

    from khmer_tpu_torch import Countgraph, Counttable, _u64, kernels
    from khmer_tpu_torch.hashtable import CHUNK
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.native import NativeChunkReader
    from khmer_tpu_torch.ops.hashing import compute_band_interval

    log("phase 3f: K12 on the first {}-lane chunk of the phase-4 file (K1 "
        "and K8 lanes) against the phase-4 .ct".format(CHUNK))
    with NativeChunkReader(reads_fa, K, CHUNK) as reader:
        codes, mask = (torch.from_numpy(a).to(dev) for a in next(iter(reader)))
    lanes = {"k1": kernels.hash2bit_canonical(codes, mask, K),
             "k8": Counttable(K, 1, 1, primes=[1009], device=dev)
             ._chunk_lanes(codes, mask)}
    del codes, mask
    st = Countgraph.load(ct, device=dev).storage
    geom, T = st._geom, st.spec.n_tables
    by_name = {}
    edges = 0

    def case(name, hashes, weights, band=None, cap=None, **kw):
        filt = {} if band is None else {"band": compute_band_interval(*band)}
        if cap is not None:
            filt.update(zip(("table", "sizes", "offsets", "recips"),
                            (st.table, *geom)), cap=cap, **kw)
        out = []
        for fn in (kernels.band_mask_weights, plain.band_mask_weights):
            total = torch.zeros(1, dtype=torch.int64, device=dev)
            out.append((fn(hashes, weights, total, **filt), total))
        err = max(max_abs_err(a, b) for a, b in zip(*out))
        if hashes.numel() < 1024:
            by_name[name] = dict(err=err, n=hashes.numel(),
                                 kept=int(out[1][1]))
            log("K12 {}: {}".format(name, json.dumps(by_name[name])))
            return err
        total = torch.zeros(1, dtype=torch.int64, device=dev)
        gathered = weights != 0
        if band is not None:
            key = _u64.sort_key(hashes)
            lo, hi = filt["band"]
            gathered &= (key >= lo + _u64.SIGN) & (key < hi + _u64.SIGN)
        n_gather = int(torch.unique(hashes[gathered]).numel()) \
            if cap is not None else 0
        n = hashes.numel()
        r = dict(err=err, n=n, passed=int(out[1][1]),
                 ms=cuda_ms(lambda: kernels.band_mask_weights(
                     hashes, weights, total, **filt), 10),
                 plain_ms=cuda_ms(lambda: plain.band_mask_weights(
                     hashes, weights, total, **filt), 3, inner=1),
                 bytes=n * 16 + n_gather * T * 4, distinct_gathered=n_gather)
        r["bound_ms"] = bound_ms(r["bytes"])
        if cap is not None:
            r["k3_ms"] = cuda_ms(lambda: kernels.sketch_get(
                st.table, hashes, *geom, cap), 10)
            r["sectors_per_s"] = int(gathered.sum()) * T / (r["ms"] * 1e-3)
        by_name[name] = r
        log("K12 {}: {}".format(name, json.dumps(r)))
        return err

    err = 0
    h1, w1 = lanes["k1"]
    h8, w8 = lanes["k8"]
    cap = st.read_cap()
    for band in ((4, 0), (4, 3), (2, 1)):
        err = max(err, case("band {} of {} k8".format(band[1], band[0]),
                            h8, w8, band))
    err = max(err, case("band 0 of 4 k1", h1, w1, (4, 0)))
    for threshold in (0, 5):
        for cm in (False, True):
            err = max(err, case(
                "mask t{}{} k1".format(threshold, " masked" if cm else ""),
                h1, w1, cap=cap, threshold=threshold, consume_masked=cm))
    err = max(err, case("mask cap 1 t0 k1", h1, w1, cap=1, threshold=0))
    err = max(err, case("band 3 of 4 + mask t0 k8", h8, w8, (4, 3), cap=cap,
                        threshold=0))
    for band in ((4, 0), (4, 3), (2, 1), (3, 1)):
        lo, hi = compute_band_interval(*band)
        hs = np.array([0, 2 ** 63 - 1, 2 ** 63, lo, hi - 1, hi,
                       2 ** 64 - 1], np.uint64)
        hs = _u64.as_tensor(hs, dev)
        ws = torch.tensor([1, 2, 3, 4, 5, -1, 7], dtype=torch.int32,
                          device=dev)
        edges += 1
        err = max(err, case("edges band {} of {}".format(band[1], band[0]),
                            hs, ws, band))
        err = max(err, case("edges band {} of {} + mask".format(
            band[1], band[0]), hs, ws, band, cap=cap, threshold=1))
    if err:
        fail("band_mask_weights disagrees with its plain version")
    main = by_name["mask t0 k1"]
    record_kernel(rec, "band_mask_weights", err, main["ms"],
                  main["plain_ms"], main["bytes"], k3_ms=main["k3_ms"],
                  sectors_per_s=main["sectors_per_s"], n=main["n"],
                  shapes={k: v for k, v in by_name.items()
                          if k != "mask t0 k1"})
    del st, lanes, h1, w1, h8, w8
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: slice 10, the banded and masked consume, at full width
# ---------------------------------------------------------------------------


def table_u32(t):
    """A table's bins as int64 values of their uint32 patterns."""
    import torch

    return t.storage.table.to(torch.int64) & 0xFFFFFFFF


def slice10_step(name, build, dev, card, runs):
    """One run of phase 9: `build()` through the kernels (profiled), then
    through the plain versions on the card; their results and tables must
    be equal.  Records the wall, busy seconds and K12 launches under
    runs[name]; returns the kernel run's (result, table object)."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    sync(dev)
    before = kernels.LAUNCHES["band_mask_weights"]
    got = {}
    wall, busy = device_share(name, lambda: got.update(r=build()), card)
    k12 = kernels.LAUNCHES["band_mask_weights"] - before
    sync(dev)
    with mock.patch.multiple(kernels, **{n: getattr(plain, n)
                                         for n in kernels.KERNELS}):
        t0 = time.perf_counter()
        ref = build()
        sync(dev)
        plain_wall = time.perf_counter() - t0
    (res, table), (pres, ptable) = got["r"], ref
    if res != pres or not torch.equal(table.storage.table,
                                      ptable.storage.table) or \
            table.n_unique_kmers() != ptable.n_unique_kmers():
        fail("(e) {}: the kernels and the plain versions differ: {} vs {}"
             .format(name, res, pres))
    del ptable
    runs[name] = dict(wall=wall, busy=busy, plain_wall=plain_wall,
                      k12_launches=k12, result=res)
    return res, table


def run_slice10(card, dev, tmp, reads_fa, pairs_fa, ct, uniq4):
    """Phase 9: (a) banding, (b) the mask, (c) both, (d) the rest of the
    API on the phase-4 table, (e) every run of (a)-(c) equal to its run
    through the plain versions.  Returns the path's launches."""
    import torch

    from khmer_tpu_torch import (Countgraph, Counttable, Nodegraph,
                                 Nodetable, kernels)
    from khmer_tpu_torch.primes import get_n_primes_near_x

    log("phase 9: banded and masked consumes -k {} -N 4 -x {:.0e} of the "
        "phase-4 and phase-5 files".format(K, TABLE_SIZE))
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    runs = {}
    # records: 111 bytes in the phase-4 file, 114 in the phase-5 file
    reads = {reads_fa: os.path.getsize(reads_fa) // 111,
             pairs_fa: os.path.getsize(pairs_fa) // 114}

    def step(name, cls, method, path, *args, **kw):
        def build():
            t = cls(K, TABLE_SIZE, 4, device=dev)
            return getattr(t, method)(path, *args, **kw), t
        res, t = slice10_step(name, build, dev, card, runs)
        runs[name]["reads"] = reads[path]
        return res, t

    # (a) the four bands of a Counttable against its full consume
    (n_reads, n_consumed), full = step("Counttable consume_seqfile",
                                       Counttable, "consume_seqfile",
                                       reads_fa)
    acc = table_u32(full)
    full_unique = full.n_unique_kmers()
    del full
    consumed = n_unique = 0
    for b in range(4):
        (nr, c), t = step("Counttable banding 4 {}".format(b), Counttable,
                          "consume_seqfile_banding", reads_fa, 4, b)
        if nr != n_reads or not runs["Counttable banding 4 {}".format(b)][
                "k12_launches"]:
            fail("(a) band {}: {} reads, K12 launched {} times".format(
                b, nr, runs["Counttable banding 4 {}".format(b)][
                    "k12_launches"]))
        acc -= table_u32(t)
        consumed += c
        n_unique += t.n_unique_kmers()
        del t
    distinct = int(uniq4.size)
    occ = 1.0 - math.exp(-distinct / min(get_n_primes_near_x(4, TABLE_SIZE)))
    bound = int(math.ceil(10 * distinct * occ ** 4)) + 10
    if acc.any() or consumed != n_consumed or \
            not 0 <= distinct - n_unique <= bound:
        fail("(a) the bands do not add up: bins off by {}, consumed {} vs "
             "{}, n_unique {} vs the exact {} (bound {})".format(
                 int(acc.abs().sum()), consumed, n_consumed, n_unique,
                 distinct, bound))
    del acc
    log("(a) 4 band tables == the full Counttable bin for bin; consumed "
        "{} == {}; n_unique {} (full {}) against {} distinct (bound {})"
        .format(consumed, n_consumed, n_unique, full_unique, distinct,
                bound))

    # (b) a Countgraph of the phase-5 file masked by a Nodegraph of the
    # phase-4 file, both ways, against the unmasked consume
    _, ng = step("Nodegraph mask consume_seqfile", Nodegraph,
                 "consume_seqfile", reads_fa)
    (_, n5), plain5 = step("Countgraph consume_seqfile (phase 5)",
                           Countgraph, "consume_seqfile", pairs_fa)
    acc = table_u32(plain5)
    del plain5
    parts = []
    for name, kw in (("absent", {}), ("present", dict(threshold=1,
                                                      consume_masked=True))):
        (_, c), t = step("Countgraph with_mask {}".format(name), Countgraph,
                         "consume_seqfile_with_mask", pairs_fa, ng, **kw)
        acc -= table_u32(t)
        parts.append(c)
        del t
    if acc.any() or sum(parts) != n5:
        fail("(b) masked + unmasked is not the unmasked consume: bins off "
             "by {}, consumed {} vs {}".format(int(acc.abs().sum()), parts,
                                               n5))
    del acc
    log("(b) threshold 0 (the k-mers absent from the phase-4 reads) + "
        "threshold 1 with consume_masked (present) == the unmasked "
        "Countgraph bin for bin; consumed {} + {} == {}; {:.4%} of the "
        "phase-5 k-mers masked out at threshold 0".format(
            parts[0], parts[1], n5, parts[1] / n5))

    # (c) band 3 of 4 of a Counttable of the phase-5 file, masked by a
    # Nodetable of the phase-4 file, both ways
    _, nt = step("Nodetable mask consume_seqfile", Nodetable,
                 "consume_seqfile", reads_fa)
    (_, c3), t = step("Counttable banding 4 3 (phase 5)", Counttable,
                      "consume_seqfile_banding", pairs_fa, 4, 3)
    acc = table_u32(t)
    del t
    parts = []
    for name, kw in (("absent", {}), ("present", dict(threshold=1,
                                                      consume_masked=True))):
        (_, c), t = step("Counttable banding_with_mask 4 3 {}".format(name),
                         Counttable, "consume_seqfile_banding_with_mask",
                         pairs_fa, 4, 3, nt, **kw)
        acc -= table_u32(t)
        parts.append(c)
        del t
    if acc.any() or sum(parts) != c3 or not c3:
        fail("(c) band 3 masked + unmasked is not band 3: bins off by {}, "
             "consumed {} vs {}".format(int(acc.abs().sum()), parts, c3))
    del acc, nt
    log("(c) band 3 of 4 at threshold 0 + at threshold 1 with "
        "consume_masked == band 3 bin for bin; consumed {} + {} == {} of "
        "{}".format(parts[0], parts[1], c3, n5))

    # (d) the rest of the API on the phase-4 table
    cg = Countgraph(K, TABLE_SIZE, 4, device=dev)
    cg.consume_seqfile(reads_fa)
    raw = [np.frombuffer(b, np.uint8) for b in cg.get_raw_tables()]
    _, _, saved = ct_tables(ct)
    if cg.n_tables() != 4 or len(raw) != len(saved) or any(
            not np.array_equal(a, b) for a, b in zip(raw, saved)):
        fail("(d) get_raw_tables is not the saved .ct's table bytes")
    seq = fixed_records(reads_fa, 1, 111, 10)[0]
    kmers = cg.get_kmers(seq)
    if len(kmers) != len(seq) - K + 1 or kmers[1] != seq[1:K + 1]:
        fail("(d) get_kmers")
    del cg, raw, saved
    halves = []
    with open(reads_fa, "rb") as f:
        data = f.read()
    cut = reads[reads_fa] // 2 * 111
    for i, part in enumerate((data[:cut], data[cut:])):
        path = os.path.join(tmp, "half{}.fa".format(i))
        with open(path, "wb") as g:
            g.write(part)
        h = Nodegraph(K, TABLE_SIZE, 4, device=dev)
        h.consume_seqfile(path)
        halves.append(h)
    before = halves[0].n_unique_kmers()
    sync(dev)
    t0 = time.perf_counter()
    halves[0].update(halves[1])
    sync(dev)
    t_update = time.perf_counter() - t0
    whole = [bytes(b) for b in ng.get_raw_tables()]
    if [bytes(b) for b in halves[0].get_raw_tables()] != whole or \
            halves[0].n_unique_kmers() != before:
        fail("(d) Nodegraph.update of the two halves is not the whole")
    log("(d) get_raw_tables == the phase-4 .ct's {} tables; get_kmers, "
        "n_tables 4; Nodegraph.update of the two halves == the whole "
        "file's Nodegraph ({:.4f} s, n_unique left at {})".format(
            len(whole), t_update, before))
    del halves, whole, ng

    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("phase 9 launches (kernel runs only): {}".format(
        json.dumps(launches)))
    log("phase 9 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    for name, r in runs.items():
        busy = r["busy"]
        log("{}: {:.3f} s (profiled) [plain {:.3f} s], {:.0f} reads/s, "
            "device busy {}, K12 launches {} [{}]".format(
                name, r["wall"], r["plain_wall"], r["reads"] / r["wall"],
                "not measured" if busy is None else
                "{:.3f} s = {:.1f}%".format(busy, 100 * busy / r["wall"]),
                r["k12_launches"], card))
    log("(e) every run of (a)-(c) == its plain-version run on the card")
    if not launches["band_mask_weights"]:
        fail("K12 was not launched by the slice-10 path")
    log("phase 9: {:.1f} s with its plain runs and checks [{}]".format(
        time.perf_counter() - t_phase, card))
    return launches

# ---------------------------------------------------------------------------
# phase 10: slice 4b, the knot-removal workflow, at full width
# ---------------------------------------------------------------------------


def make_lump_metagenome(path, seed, n_genomes, n_reads, n_carriers,
                         n_repeats, repeat_len, readlen=100, err=0.005):
    """make_metagenome's reads (random genomes of 1-8 kbases, 0.5%
    substitutions, half reverse-complemented, 112-byte records) with
    `n_carriers` genomes carrying two of `n_repeats` random repeats of
    `repeat_len` bases each, one in each half: the carriers join through
    the repeats into one lump.  Returns (bases, the carriers' bases)."""
    rng = np.random.default_rng(seed + 10)
    lens = rng.integers(1000, 8001, n_genomes)
    offs = np.concatenate([[0], np.cumsum(lens)])
    genome = rng.integers(0, 4, int(offs[-1]), dtype=np.uint8)
    repeats = rng.integers(0, 4, (n_repeats, repeat_len), dtype=np.uint8)
    carriers = rng.choice(n_genomes, n_carriers, replace=False)
    for g in carriers:
        half = lens[g] // 2
        for r, lo in zip(rng.choice(n_repeats, 2, replace=False),
                         (0, half)):
            at = offs[g] + lo + rng.integers(0, half - repeat_len + 1)
            genome[at:at + repeat_len] = repeats[r]
    starts = lens - readlen + 1
    which = rng.choice(n_genomes, n_reads, p=starts / starts.sum())
    at = offs[which] + (rng.random(n_reads) * starts[which]).astype(np.int64)
    reads = genome[at[:, None] + np.arange(readlen)]
    hit = rng.random(reads.shape, dtype=np.float32) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    rec = np.empty((n_reads, 12 + readlen), np.uint8)
    rec[:, 0:2] = np.frombuffer(b">m", np.uint8)
    pows = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    rec[:, 2:10] = (np.arange(n_reads)[:, None] // pows) % 10 + ord("0")
    rec[:, 10] = ord("\n")
    rec[:, 11:11 + readlen] = np.frombuffer(b"ACGT", np.uint8)[reads]
    rec[:, -1] = ord("\n")
    rec.tofile(path)
    return int(offs[-1]), int(lens[carriers].sum())


def knot_steps(fa):
    """The documented knot-removal workflow's runs (steps 1-5), as (name,
    script module, argv); the table cut to -x 1e8 (BitStorage: a u32 bin a
    bit) and extract-partitions' group size to -X KNOT_GROUP."""
    from khmer_tpu_torch.scripts import (annotate_partitions, do_partition,
                                         extract_partitions, filter_stoptags,
                                         find_knots, load_graph,
                                         make_initial_stoptags,
                                         merge_partitions, partition_graph)

    graph = ["-k", str(PARTITION_K), "-N", "4", "-x", repr(TABLE_SIZE)]
    name = os.path.basename(fa)
    return [
        ("do-partition", do_partition.main,
         graph + ["-s", "1e5", "g", fa]),
        ("extract-partitions", extract_partitions.main,
         ["-X", str(KNOT_GROUP), "g", name + ".part"]),
        ("load-graph", load_graph.main, graph + ["lump", "lump.fa"]),
        ("make-initial-stoptags", make_initial_stoptags.main, ["lump"]),
        ("partition-graph --stoptags", partition_graph.main,
         ["--stoptags", "lump.stoptags", "lump"]),
        ("find-knots", find_knots.main, ["-x", "2e8", "-N", "4", "lump"]),
        ("filter-stoptags", filter_stoptags.main,
         ["lump.stoptags", "lump.fa"]),
        # step 5, on the card alone: phase 7's scripts on the cut reads
        ("load-graph (filtered)", load_graph.main,
         graph + ["lumpfilt", "lump.fa.stopfilt"]),
        ("partition-graph (filtered)", partition_graph.main, ["lumpfilt"]),
        ("merge-partitions (filtered)", merge_partitions.main, ["lumpfilt"]),
        ("annotate-partitions (filtered)", annotate_partitions.main,
         ["lumpfilt", "lump.fa.stopfilt"]),
        ("extract-partitions (filtered)", extract_partitions.main,
         ["lumpfilt-out", "lump.fa.stopfilt.part"])]


def knot_scripts(workdir, fa, dev, card):
    """The runs of knot_steps on `dev`, in `workdir`, each profiled;
    after extract-partitions the largest group file becomes lump.fa.
    Returns walls, device busy seconds, K3 launches by script,
    _KnotWalk's numbers by repartition call, and after each run the
    sha256 of every file in workdir."""
    import shutil

    from khmer_tpu_torch import kernels, partitioning

    os.makedirs(workdir)
    out = {"walls": {}, "busy": {}, "k3": {}, "files": {}, "knots": []}
    repartition = partitioning.SubsetPartition.repartition_largest_partition

    def keep_stats(subset, *args, **kwargs):
        size = repartition(subset, *args, **kwargs)
        out["knots"].append(dict(subset.knot_stats, size=size))
        return size

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for name, fn, argv in knot_steps(fa):
            err = io.StringIO()
            run = lambda: fn(argv, device=dev)  # noqa: E731
            before = kernels.LAUNCHES["sketch_get"]
            sync(dev)
            try:
                with contextlib.redirect_stderr(err), mock.patch.object(
                        partitioning.SubsetPartition,
                        "repartition_largest_partition", keep_stats):
                    wall, busy = device_share(name, run, card)
                    out["busy"][name] = busy
            except BaseException:
                sys.stderr.write(err.getvalue()[-20000:])
                raise
            out["walls"][name] = wall
            out["k3"][name] = kernels.LAUNCHES["sketch_get"] - before
            if name == "make-initial-stoptags":
                out["initial_stop_tags"] = \
                    (os.path.getsize("lump.stoptags") - 18) // 8
            if name == "extract-partitions":
                groups = sorted((os.path.getsize(f), f)
                                for f in os.listdir(".") if ".group" in f)
                shutil.copy(groups[-1][1], "lump.fa")
                out["groups"] = [g for _, g in groups]
            log("phase 10 {} done, {:.1f} s into the smoke".format(
                name, time.perf_counter() - STARTED))
            out["files"][name] = {}
            for f in sorted(os.listdir(".")):
                if f != os.path.basename(fa):
                    with open(f, "rb") as fh:
                        out["files"][name][f] = hashlib.sha256(
                            fh.read()).hexdigest()
            gc.collect()
        out["sizes"] = {f: os.path.getsize(f) for f in sorted(os.listdir("."))}
    finally:
        os.chdir(cwd)
    return out


def partitions_in(part_file):
    """The distinct partition ids of an annotated file and its reads."""
    pids = {}
    with open(part_file, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                pid = int(line.rsplit(b"\t", 1)[1])
                pids[pid] = pids.get(pid, 0) + 1
    return pids


def run_knots(card, dev, tmp, seed):
    """Phase 10: the knot-removal workflow on a metagenome with a lump,
    through the port's scripts on the card; returns the path's
    launches.  (Its plain-version runs of steps 1-4, about 75 s, were cut
    for the time limit: K1-K3 and bin_scatter_add, all its kernels, are
    held to their plain versions in phase 3.)"""
    import torch

    from khmer_tpu_torch import kernels

    wd = os.path.join(tmp, "p10")
    os.makedirs(wd)
    fa = os.path.join(wd, "reads.fa")
    t_phase = time.perf_counter()
    bases, lump_bases = make_lump_metagenome(
        fa, seed, KNOT_GENOMES, KNOT_READS, KNOT_CARRIERS,
        KNOT_REPEATS, KNOT_REPEAT_LEN)
    log("phase 10: {} reads of 100 bp over {} random genomes of 1-8 kbases "
        "({} bases), {} of them ({} bases) carrying two of {} repeats of {} "
        "bases; 0.5% substitutions, half reverse-complemented, {:.1f} s to "
        "write".format(KNOT_READS, KNOT_GENOMES, bases,
                       KNOT_CARRIERS, lump_bases, KNOT_REPEATS,
                       KNOT_REPEAT_LEN, time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = knot_scripts(os.path.join(wd, "kernels"), fa, dev, card)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("phase 10 launches: {}".format(json.dumps(launches)))
    log("phase 10 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in KNOT_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the knot-removal path: {}".format(
            missing))
    lump_reads = os.path.getsize(os.path.join(wd, "kernels", "lump.fa")) \
        // 112
    for name, wall in got["walls"].items():
        busy = got["busy"].get(name)
        log("{}: {:.3f} s (profiled), device busy {}, K3 launches {} "
            "[{}]".format(name, wall, "not measured" if busy is None else
                          "{:.3f} s = {:.1f}%".format(busy,
                                                      100 * busy / wall),
                          got["k3"][name], card))
    for i, st in enumerate(got["knots"]):
        log("repartition_largest_partition call {}: {}".format(
            i, json.dumps(st)))
    final = got["files"]["filter-stoptags"]
    n_stop = (got["sizes"]["lump.stoptags"] - 18) // 8
    if not n_stop or "lump.fa.stopfilt" not in final or \
            not any(f.endswith(".pmap.processed") for f in final):
        fail("phase 10 found {} stop tags".format(n_stop))
    before = partitions_in(os.path.join(wd, "kernels", "reads.fa.part"))
    after = partitions_in(os.path.join(wd, "kernels",
                                       "lump.fa.stopfilt.part"))
    lump_pids = set()
    with open(os.path.join(wd, "kernels", "lump.fa"), "rb") as f:
        for line in f:
            if line.startswith(b">"):
                lump_pids.add(int(line.rsplit(b"\t", 1)[1]))
    log("phase 10 ({} files after filter-stoptags): do-partition's .part "
        "sha256 {}; "
        "{} stop tags (initial {}); the lump: {} reads in {} ({} groups), "
        "{} partitions before the filter (the largest {} reads), {} after "
        "it (the largest {} reads), {} filtered reads kept; sizes {}".format(
            len(final), got["files"]["do-partition"]["reads.fa.part"],
            n_stop, got["initial_stop_tags"], lump_reads, got["groups"][-1],
            len(got["groups"]), len(lump_pids),
            max(before[p] for p in lump_pids), len(after),
            max(after.values()) if after else 0, sum(after.values()),
            json.dumps(got["sizes"])))
    log("phase 10: {:.1f} s with its checks [{}]".format(
        time.perf_counter() - t_phase, card))
    return launches


# ---------------------------------------------------------------------------
# phase 11: slice 4c, labels, assembly and the read aligner, at full width
# ---------------------------------------------------------------------------


def write_reads(path, names, reads):
    """FASTA records of 2-bit code rows (A C G T = 0 1 2 3) under the
    given names (bytes)."""
    seqs = np.frombuffer(b"ACGT", np.uint8)[reads]
    with open(path, "wb") as f:
        f.write(b"".join(b">%s\n%s\n" % (nm, row.tobytes())
                         for nm, row in zip(names, seqs)))


def sample_reads(rng, genome, offs, lens, which, readlen=100, err=0.005):
    """A read of `readlen` bases at a random start of each genome in
    `which`, a share `err` of its bases substituted, half of them
    reverse-complemented: 2-bit rows [len(which), readlen]."""
    starts = lens[which] - readlen + 1
    at = offs[which] + (rng.random(which.size) * starts).astype(np.int64)
    reads = genome[at[:, None] + np.arange(readlen)]
    hit = rng.random(reads.shape, dtype=np.float32) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    rc = rng.random(which.size) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    return reads


def make_sweep_files(ref_path, reads_path, seed):
    """sweep-reads' reference (reads named '<name>\\t<genome index>') and
    reads to sweep (a tenth of them from genomes absent from the
    reference).  Returns the reference genomes' bases."""
    rng = np.random.default_rng(seed + 11)
    n = SWEEP_GENOMES + SWEEP_ABSENT
    lens = rng.integers(1000, 8001, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    genome = rng.integers(0, 4, int(offs[-1]), dtype=np.uint8)

    def pick(lo, hi, count):
        p = (lens[lo:hi] - 99) / (lens[lo:hi] - 99).sum()
        return lo + rng.choice(hi - lo, count, p=p)

    which = pick(0, SWEEP_GENOMES, SWEEP_REF_READS)
    write_reads(ref_path, [b"r%d\t%d" % (i, g)
                           for i, g in enumerate(which.tolist())],
                sample_reads(rng, genome, offs, lens, which))
    which = np.concatenate([pick(0, SWEEP_GENOMES, SWEEP_READS),
                            pick(SWEEP_GENOMES, n, SWEEP_READS // 10)])
    rng.shuffle(which)
    write_reads(reads_path, [b"q%d" % i for i in range(which.size)],
                sample_reads(rng, genome, offs, lens, which))
    return int(offs[SWEEP_GENOMES])


def make_coding_reads(path, seed):
    """OTG_READS reads over a genome of OTG_GENOME bases of random
    stop-free codons, whose contigs hold long open reading frames."""
    rng = np.random.default_rng(seed + 12)
    codons = np.array([c for c in np.ndindex(4, 4, 4) if "".join(
        "ACGT"[i] for i in c) not in ("TAA", "TAG", "TGA")], np.uint8)
    genome = codons[rng.integers(0, len(codons), OTG_GENOME // 3)]
    genome = genome.reshape(-1)
    which = np.zeros(OTG_READS, np.int64)
    write_reads(path, [b"c%d" % i for i in range(OTG_READS)],
                sample_reads(rng, genome, np.array([0]),
                             np.array([genome.size]), which))


class _Tally:
    """Calls and seconds of a method, counted through a wrapper."""

    def __init__(self, owner, name):
        self.calls = 0
        self.seconds = 0.0
        method = getattr(owner, name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return method(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        self.patch = mock.patch.object(owner, name, wrapped)


def slice4c_steps(files):
    """Phase 11's runs: (name, sandbox module, argv)."""
    from khmer_tpu_torch.sandbox import (assemble_on_the_go, correct_reads,
                                         sweep_reads)

    graph = ["-N", "4", "-x", repr(TABLE_SIZE)]
    return [
        ("correct-reads", correct_reads,
         ["-k", str(K)] + graph + [files["pairs"]]),
        ("sweep-reads", sweep_reads,
         ["--label-by-pid"] + graph + ["--outdir", ".", files["ref"],
                                       files["reads"]]),
        ("assemble-on-the-go", assemble_on_the_go, [files["coding"]])]


def slice4c_runs(workdir, files, dev, profile, card):
    """Phase 11's runs on `dev`, in `workdir`: walls (and device busy
    seconds when `profile`), K3 launches, stdout, stderr lines (with the
    temporary directory's name marked) and the sha256 of every file
    written, and each run's counted calls."""
    import re

    from khmer_tpu_torch import assembly, kernels, readaligner, storage

    os.makedirs(workdir)
    out = {"walls": {}, "busy": {}, "k3": {}, "outputs": {}, "tallies": {}}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for name, module, argv in slice4c_steps(files):
            tallies = {
                "alignments": _Tally(readaligner.ReadAligner,
                                     "_align_hashed"),
                "native": _Tally(readaligner.ReadAligner,
                                 "_native_subalign"),
                "snapshots": _Tally(storage.Storage, "_take_snapshot"),
                "assemblies": _Tally(assembly.SimpleLabeledAssembler,
                                     "assemble"),
                "steps": _Tally(assembly.LinearAssembler, "_next_symbol")}
            stdout, stderr = io.StringIO(), io.StringIO()

            def run():
                with contextlib.redirect_stdout(stdout), \
                        contextlib.redirect_stderr(stderr):
                    module.main(argv, device=dev)

            before = kernels.LAUNCHES["sketch_get"]
            sync(dev)
            with contextlib.ExitStack() as stack:
                for t in tallies.values():
                    stack.enter_context(t.patch)
                stack.enter_context(mock.patch.object(
                    sys, "argv", [name + ".py"] + argv))
                try:
                    if profile:
                        wall, busy = device_share(name, run, card)
                        out["busy"][name] = busy
                    else:
                        t0 = time.perf_counter()
                        run()
                        sync(dev)
                        wall = time.perf_counter() - t0
                except BaseException:
                    sys.stderr.write(stderr.getvalue()[-20000:])
                    raise
            out["walls"][name] = wall
            out["k3"][name] = kernels.LAUNCHES["sketch_get"] - before
            out["tallies"][name] = {k: (t.calls, t.seconds)
                                    for k, t in tallies.items()}
            files_now = {}
            for f in sorted(os.listdir(".")):
                with open(f, "rb") as fh:
                    files_now[f] = hashlib.sha256(fh.read()).hexdigest()
            out["outputs"][name] = (
                stdout.getvalue(),
                [re.sub(r"\S*tmp\w+khmer", "<tmp>", ln)
                 for ln in stderr.getvalue().splitlines()], files_now)
            log("phase 11 {} done, {:.1f} s into the smoke".format(
                name, time.perf_counter() - STARTED))
            gc.collect()
    finally:
        os.chdir(cwd)
    return out


def snapshot_copy_ms(dev, card):
    """A device-to-host copy of a table of 4 x 1e8 u32 bins (the
    snapshot's copy), into pageable and into pinned host memory."""
    import torch

    from khmer_tpu_torch.ops.sketch_ops import SketchSpec, alloc_table
    from khmer_tpu_torch.primes import get_n_primes_near_x

    table = alloc_table(SketchSpec("byte", tuple(get_n_primes_near_x(
        4, TABLE_SIZE))), dev)
    t0 = time.perf_counter()
    pinned = torch.empty(table.shape, dtype=table.dtype, pin_memory=True)
    alloc_ms = 1e3 * (time.perf_counter() - t0)
    times = {}
    for kind in ("pageable", "pinned", "pageable", "pinned"):
        sync(dev)
        t0 = time.perf_counter()
        if kind == "pinned":
            pinned.copy_(table)
        else:
            table.to("cpu", copy=True)
        times.setdefault(kind, []).append(
            1e3 * (time.perf_counter() - t0))
    log("snapshot copy of {} bytes: pageable {} ms, pinned {} ms (the "
        "pinned buffer's allocation {:.1f} ms) [{}]".format(
            table.numel() * 4, ", ".join("{:.1f}".format(t)
                                         for t in times["pageable"]),
            ", ".join("{:.1f}".format(t) for t in times["pinned"]),
            alloc_ms, card))


def run_slice4c(card, dev, tmp, seed):
    """Phase 11: correct-reads, sweep-reads and assemble-on-the-go through
    the port's sandbox scripts on the card, held to the same runs through
    the plain versions; returns the path's launches."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    wd = os.path.join(tmp, "p11")
    os.makedirs(wd)
    files = {n: os.path.join(wd, n + ".fa")
             for n in ("pairs", "ref", "reads", "coding")}
    t_phase = time.perf_counter()
    span = make_pairs(files["pairs"], seed, CORRECT_READS, CORRECT_COVERAGE)
    ref_bases = make_sweep_files(files["ref"], files["reads"], seed)
    make_coding_reads(files["coding"], seed)
    log("phase 11: correct-reads on {} reads in pairs at {}x over the first "
        "{} bases of the phase-4 genome; sweep-reads of {} + {} reads "
        "against {} reference reads over {} genomes ({} bases; {} absent "
        "genomes); assemble-on-the-go on {} reads at 40x over {} bases of "
        "stop-free codons; 0.5% substitutions; {:.1f} s to write".format(
            CORRECT_READS, CORRECT_COVERAGE, span, SWEEP_READS,
            SWEEP_READS // 10, SWEEP_REF_READS, SWEEP_GENOMES, ref_bases,
            SWEEP_ABSENT, OTG_READS, OTG_GENOME,
            time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = slice4c_runs(os.path.join(wd, "kernels"), files, dev, True, card)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("phase 11 launches: {}".format(json.dumps(launches)))
    log("phase 11 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in SLICE4C_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the slice-4c path: {}".format(missing))
    for name, wall in got["walls"].items():
        busy = got["busy"].get(name)
        log("{}: {:.3f} s (profiled), device busy {}, K3 launches {} "
            "[{}]".format(name, wall, "not measured" if busy is None else
                          "{:.3f} s = {:.1f}%".format(busy,
                                                      100 * busy / wall),
                          got["k3"][name], card))
    snapshot_copy_ms(dev, card)
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = slice4c_runs(os.path.join(wd, "plain"), files, dev, False,
                           card)
    log("phase 11 plain-version walls (s): {} [{}]".format(
        json.dumps(ref["walls"]), card))
    for name, want in ref["outputs"].items():
        mine = got["outputs"][name]
        if mine != want:
            fail("slice-4c path differs from its plain run in {}: stdout "
                 "{}; stderr lines {}; files {}".format(
                     name, "equal" if mine[0] == want[0] else "differs",
                     [(x, y) for x, y in zip(mine[1], want[1])
                      if x != y][:5] + ([len(mine[1]), len(want[1])]
                                        if len(mine[1]) != len(want[1])
                                        else []),
                     sorted(f for f in set(mine[2]) | set(want[2])
                            if mine[2].get(f) != want[2].get(f))))
    t = got["tallies"]
    a, b, c = (got["outputs"][n][1] for n in
               ("correct-reads", "sweep-reads", "assemble-on-the-go"))
    n_align, align_s = t["correct-reads"]["alignments"]
    n_native, native_s = t["correct-reads"]["native"]
    n_snap, snap_s = t["correct-reads"]["snapshots"]
    corrected = [ln for ln in a if ln.startswith("corrected ")]
    log("correct-reads: {}; {} alignments, {:.1f} us an alignment ({} "
        "native searches, {:.1f} us of them an alignment, the Python "
        "around the C call included); {} snapshot copies, {:.1f} ms in "
        "all [{}]".format(corrected, n_align, 1e6 * align_s / max(n_align, 1),
                          n_native, 1e6 * native_s / max(n_align, 1), n_snap,
                          1e3 * snap_s, card))
    log("sweep-reads: {} [{}]".format(
        [ln for ln in b if ln.startswith(("swept ", "...with", "...and"))],
        card))
    n_asm, asm_s = t["assemble-on-the-go"]["assemblies"]
    n_steps, _ = t["assemble-on-the-go"]["steps"]
    orfs = got["outputs"]["assemble-on-the-go"][0].count(">orf")
    log("assemble-on-the-go: {} ORFs, {} assemblies, {} assembler steps, "
        "{:.1f} us a step (assemble's seconds over its steps), {:.3f} s "
        "in assemble [{}]".format(orfs, n_asm, n_steps,
                                  1e6 * asm_s / max(n_steps, 1), asm_s,
                                  card))
    if not corrected or corrected[0] == "corrected 0 reads" or not orfs \
            or not any(ln.startswith("...and ") for ln in b):
        fail("phase 11 corrected, swept or assembled nothing")
    log("kernels == plain on the card: stdout, stderr and every output "
        "file of the three runs; phase 11: {:.1f} s with its plain runs "
        "[{}]".format(time.perf_counter() - t_phase, card))
    return launches


# ---------------------------------------------------------------------------
# phase 12: slice 5, the quotient filter, at full width
# ---------------------------------------------------------------------------


def qf_hashes(seqs, dev, murmur, rows=1 << 16):
    """The K8 hashes by `murmur` (the kernel's wrapper or its plain
    version; khmer's full complement) of every 20-mer of 100-bp reads
    (bytes), int64 on the card."""
    import torch

    byts = np.frombuffer(b"".join(seqs), np.uint8).reshape(len(seqs), -1)
    out = []
    for lo in range(0, byts.shape[0], rows):
        b = torch.from_numpy(byts[lo: lo + rows].copy()).to(dev)
        lengths = torch.full((b.shape[0],), b.shape[1], dtype=torch.int32,
                             device=dev)
        out.append(murmur(b, lengths, K)[0].reshape(-1))
    return torch.cat(out)


def qf_steps(pairs_fa, unique):
    sizing = ["-k", str(K), "-U", str(unique)]
    return [
        ("normalize-by-median --mqf", "normalize_by_median",
         sizing + ["--mqf", "-p", "-C", "5", "-o", "mqf.fa", pairs_fa]),
        ("normalize-by-median --bmqf", "normalize_by_median",
         sizing + ["--bmqf", "-p", "-C", "5", "-o", "bmqf.fa", pairs_fa]),
        ("trim-low-abund --mqf", "trim_low_abund",
         sizing + ["--mqf", "-C", "2", "-o", "trim.fa", pairs_fa]),
    ]


def qf_table_run(table, dev):
    """A QFCounttable of table["slots"] slots (rounded up to a power of
    two): consume table["fa"], save, load and read the counts of the
    table["sample"] hashes and the median counts of the reads
    table["heads"]."""
    from khmer_tpu_torch import QFCounttable

    qf = QFCounttable(K, table["slots"], device=dev)
    out = {"consume": qf.consume_seqfile(table["fa"]),
           "n_unique": qf.n_unique_kmers(), "range": int(qf.storage.range)}
    qf.save("table.qf")
    loaded = QFCounttable.load("table.qf", device=dev)
    out["loaded n_unique"] = loaded.n_unique_kmers()
    out["sample counts"] = loaded.storage.get_batch(
        table["sample"]).tolist()
    out["medians"] = hashlib.sha256(json.dumps(
        loaded.get_median_count_batch(table["heads"])).encode()).hexdigest()
    return out


def qf_runs(workdir, pairs_fa, unique, table, dev, profile, card):
    """Phase 12's runs on `dev`, in `workdir` (the QFCounttable's when
    `table` is not None): walls (and device busy seconds when `profile`),
    stdout, stderr lines (the temporary directory's name marked), the
    sha256 of every file written, K8 launches and the QFCounttable's
    results."""
    import importlib
    import re

    from khmer_tpu_torch import kernels, khmer_logger

    os.makedirs(workdir)
    out = {"walls": {}, "busy": {}, "k8": {}, "outputs": {}}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        steps = qf_steps(pairs_fa, unique) + (
            [("QFCounttable", None, None)] if table is not None else [])
        for name, module, argv in steps:
            stdout, stderr = io.StringIO(), io.StringIO()
            got = {}

            def run():
                # the banner prints before a script reads -q: start each
                # run from the same logging state
                khmer_logger.configure_logging(False)
                with contextlib.redirect_stdout(stdout), \
                        contextlib.redirect_stderr(stderr):
                    if module is None:
                        got.update(qf_table_run(table, dev))
                    else:
                        importlib.import_module(
                            "khmer_tpu_torch.scripts." + module).main(
                                argv, device=dev)

            before = kernels.LAUNCHES["murmur_hashes"]
            sync(dev)
            try:
                if profile:
                    wall, busy = device_share(name, run, card)
                    out["busy"][name] = busy
                else:
                    t0 = time.perf_counter()
                    run()
                    sync(dev)
                    wall = time.perf_counter() - t0
            except BaseException:
                sys.stderr.write(stderr.getvalue()[-20000:])
                raise
            out["walls"][name] = wall
            out["k8"][name] = kernels.LAUNCHES["murmur_hashes"] - before
            files_now = {}
            for f in sorted(os.listdir(".")):
                with open(f, "rb") as fh:
                    files_now[f] = hashlib.sha256(fh.read()).hexdigest()
            out["outputs"][name] = (
                stdout.getvalue(),
                [re.sub(r"\S*tmp\w+khmer", "<tmp>", ln)
                 for ln in stderr.getvalue().splitlines()], files_now)
            if got:
                out["table"] = got
            log("phase 12 {} done, {:.1f} s into the smoke".format(
                name, time.perf_counter() - STARTED))
            gc.collect()
    finally:
        os.chdir(cwd)
    return out


def run_qf(card, dev, tmp, pairs_fa, seed):
    """Phase 12: normalize-by-median --mqf and --bmqf and trim-low-abund
    --mqf on the first QF_READS reads of the phase-5 file, -k 20 and -U
    their exact distinct k-mers, through the kernels (profiled) and
    through the plain versions, and a QFCounttable on the first
    QF_TABLE_READS, held to an oracle from the plain K8 hashes, which the
    kernel's equal.  Returns the path's launches."""
    import torch

    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain

    t_phase = time.perf_counter()
    qf_fa = os.path.join(tmp, "qf.fa")
    table = {"fa": os.path.join(tmp, "qf_table.fa")}
    with open(pairs_fa, "rb") as f:
        head = f.read(QF_READS * 114)
    for path, n in ((qf_fa, QF_READS), (table["fa"], QF_TABLE_READS)):
        with open(path, "wb") as g:
            g.write(head[:n * 114])
    seqs = head.split(b"\n")[1::2]
    del head
    table["heads"] = [r.decode() for r in seqs[:BATCH]]
    h = qf_hashes(seqs, dev, plain.murmur_hashes)
    if not torch.equal(qf_hashes(seqs, dev, kernels.murmur_hashes), h):
        fail("phase 12: K8's hashes of the reads differ from its plain "
             "version's")
    del seqs
    unique = int(torch.unique(h).numel())
    # the table's hashes: its reads' windows lead h, 81 a read
    ht = h[:QF_TABLE_READS * (100 - K + 1)]
    table_unique = int(torch.unique(ht).numel())
    # the classic constructor (8 remainder bits), with room for the count
    # slots: at 40x most keys take two slots in the saved dump
    table["slots"] = 4 * table_unique
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sample = ht[torch.randint(0, ht.numel(), (4096,), generator=gen,
                              device=dev)]
    table["sample"] = _u64_numpy(sample)
    log("phase 12: the quotient filter: the scripts on the first {} reads "
        "of the phase-5 file ({} 20-mers, {} distinct: -U), the table on "
        "the first {} ({} distinct); {:.1f} s to hash them with K8 and its "
        "plain version, equal".format(QF_READS, h.numel(), unique, QF_TABLE_READS,
                    table_unique, time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = qf_runs(os.path.join(tmp, "p12_kernels"), qf_fa, unique, table,
                  dev, True, card)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("phase 12 launches: {}; K8 by run: {}".format(
        json.dumps(launches), json.dumps(got["k8"])))
    log("phase 12 peak device memory: {} bytes = {:.3f} GiB "
        "(max_memory_allocated) [{}]".format(peak, peak / 2 ** 30, card))
    missing = [k for k in QF_PATH if launches[k] == 0] + \
        [name for name, n in got["k8"].items() if n == 0]
    if missing:
        fail("kernels not launched by the QF path: {}".format(missing))
    for name, wall in got["walls"].items():
        busy = got["busy"].get(name)
        reads = QF_TABLE_READS if name == "QFCounttable" else QF_READS
        log("{}: {:.3f} s (profiled), {:.0f} reads/s, device busy {} [{}]"
            .format(name, wall, reads / wall,
                    "not measured" if busy is None else
                    "{:.3f} s = {:.1f}%".format(busy, 100 * busy / wall),
                    card))
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        ref = qf_runs(os.path.join(tmp, "p12_plain"), qf_fa, unique, None,
                      dev, False, card)
    log("phase 12 plain-version walls (s): {} [{}]".format(
        json.dumps(ref["walls"]), card))
    for name in ref["outputs"]:
        if got["outputs"][name] != ref["outputs"][name]:
            fail("phase 12 {} differs from its plain run (stdout, stderr or "
                 "files)".format(name))
    # the oracle: the filter's keys are the hashes mod its range
    result = got["table"]
    keys = ht & (result["range"] - 1)
    uniq, counts = torch.unique(keys, return_counts=True)
    want = counts[torch.searchsorted(uniq, sample & (result["range"] - 1))]
    want = (want & 0xFFFF).tolist()
    if result["n_unique"] != uniq.numel() or \
            result["loaded n_unique"] != uniq.numel() or \
            result["sample counts"] != want:
        fail("phase 12 oracle: n_unique {} (loaded {}) against {} distinct "
             "keys, {} of 4096 sampled counts off".format(
                 result["n_unique"], result["loaded n_unique"], uniq.numel(),
                 sum(a != b for a, b in zip(result["sample counts"], want))))
    kept = {name: count_records(os.path.join(tmp, "p12_kernels", f))
            for name, f in (("--mqf", "mqf.fa"), ("--bmqf", "bmqf.fa"),
                            ("trim --mqf", "trim.fa"))}
    if kept["--mqf"] != kept["--bmqf"] or \
            not 0 < kept["--mqf"][0] < QF_READS:
        fail("phase 12 kept {}".format(json.dumps(kept)))
    log("kernels == plain on the card: stdout, stderr and every file of the "
        "three scripts; oracle: n_unique {} == distinct murmur % {} keys of "
        "the plain K8 hashes, 4096 sampled counts exact; consume {}; reads, "
        "bases written {}; phase 12: {:.1f} s with its plain runs [{}]"
        .format(result["n_unique"], result["range"], result["consume"],
                json.dumps(kept), time.perf_counter() - t_phase, card))
    return launches


# ---------------------------------------------------------------------------
# phase 13: slice 7a, the sharded consume, query and CC, and two processes
# ---------------------------------------------------------------------------


def shard_lanes(path, dev):
    """The first FLAT-base chunk of a file as a shard of the sharded
    consumer appends it: its K1 lanes as (keys, SENTINEL where the weight
    is 0; unit weights; stream positions), and the hashes of every lane."""
    import torch

    from khmer_tpu_torch.hashtable import chunk_lanes
    from khmer_tpu_torch.native import NativeChunkReader

    with NativeChunkReader(path, K, FLAT) as reader:
        codes, mask = next(iter(reader))
    h, w = chunk_lanes(torch.from_numpy(codes).to(dev),
                       torch.from_numpy(mask).to(dev), K)
    live = w != 0
    return (torch.where(live, h, -1), live.to(torch.int32),
            torch.arange(h.numel(), dtype=torch.int32, device=dev)), h


def cap_dest_of(window, shards=SHARDS):
    """The consumer's room a destination for a routing window
    (parallel/sharded.py, finish)."""
    mean = -(-window // shards)
    return max(64, (mean + mean // 7 + 7) & ~7)


def sorted_by_key(out):
    """(keys, weights, firsts) of a combine's first n_valid lanes, sorted
    by key, and n_valid."""
    import torch

    from khmer_tpu_torch import _u64

    k, w, f, nv = out
    n = int(nv.item())
    order = torch.sort(_u64.sort_key(k[:n]), stable=True)[1]
    return (k[:n][order], w[:n][order], f[:n][order], nv)


def gathers_alone(table, keys, spec, geom):
    """K3t on the table and K20 on its piece 0 (cut in BINSHARD_PIECES as
    Storage.shard_table cuts it), on the keys: each kernel alone
    (torch.profiler), the random sectors it reads a second by that time,
    and a wrapper call by CUDA events on the same input, for phases 13 (a)
    and 14 (a)'s records."""
    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.storage import piece_bounds

    lo, hi = piece_bounds(spec, table.numel(), BINSHARD_PIECES)[0]
    piece = table[lo:hi].clone()
    bins = plain._bins(keys, *geom[:2])
    owned = int(((bins >= lo) & (bins < hi)).sum())
    del bins
    out = {}
    for name, fn, sectors in (
            ("sketch_get_tables",
             lambda: kernels.sketch_get_tables(table, keys, *geom),
             keys.numel() * len(spec.tablesizes)),
            ("owned_get", lambda: kernels.owned_get(keys, piece, lo, *geom),
             owned)):
        alone = kernel_alone_ms(fn, name + "_kernel")
        out[name] = dict(
            kernel_only_ms=alone, kernel_only_keys=keys.numel(),
            kernel_only_wrapper_ms=cuda_ms(fn, 10),
            kernel_only_sectors_per_s=sectors / (alone * 1e-3)
            if alone else None)
        log("{} alone (torch.profiler; None: not measured) on {} distinct "
            "random keys, {} sectors: {}".format(name, keys.numel(), sectors,
                                                 json.dumps(out[name])))
    return out


def kernel_alone_ms(fn, kernel, reps=5):
    """Device time per call of fn's CUDA kernels whose name holds
    `kernel` (torch.profiler), or None where the profile holds none.  In a
    fresh process the profile holds them; ten minutes into the smoke a
    window of a few such calls came back without them, so the smoke takes
    these times in phase 3."""
    by_name = kernel_ms_by_name(fn, reps)
    return sum(v for k, v in by_name.items() if kernel in k) or None


def gather_timed(sectors, kernel, plain_fn, idx=None, table=None):
    """A gather kernel (K3t, K20) against its plain version on one input:
    max_abs_err, ms a wrapper call (CUDA events), the plain version's ms,
    the random table sectors it requests (`sectors`: a bin each; duplicate
    keys may hit L2) a second, and, with idx, the library gather
    table[idx] of the precomputed bins."""
    err = max_abs_err(kernel(), plain_fn())
    ms = cuda_ms(kernel, 10)
    out = dict(err=err, ms=ms, plain_ms=cuda_ms(plain_fn, 3),
               sectors_per_s=sectors / (ms * 1e-3))
    if idx is not None:
        out["library_ms"] = cuda_ms(lambda: table[idx], 10)
    return out


def check_shard_kernels(seed, dev, reads_fa, ct, rec, star):
    """Phase 13 (a): K15, K16, K17, K3t and K10's relax and jump entry
    points against their plain versions on the card, bit for bit (K16
    after a sort by key), with CUDA-event times, the bytes-once bound
    and, for K3t, the library gather table[idx]."""
    import torch

    from khmer_tpu_torch import Countgraph, kernels
    from khmer_tpu_torch.kernels import plain

    log("phase 13 (a): K15 and K16 on the first 2**23-lane chunk of the "
        "phase-4 file and on a hot chunk (one k-mer, poly-A, on half the "
        "lanes), K17 on that chunk's distinct lanes against the phase-4 "
        ".ct and virgin, K3t on its 2**23 hashes, K10's relax and jump on "
        "phase 7's star")
    lanes, hashes = shard_lanes(reads_fa, dev)
    n = hashes.numel()
    hot = (lanes[0].clone(), torch.ones_like(lanes[1]), lanes[2])
    hot[0][::2] = 0  # the canonical 2-bit hash of poly-A
    cap = cap_dest_of(n)
    # K15
    runs = {}
    for name, inp in (("chunk", lanes), ("hot", hot)):
        got = kernels.band_route(*inp, SHARDS, cap)
        want = plain.band_route(*inp, SHARDS, cap)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        runs[name] = dict(
            err=err, n_left=int(got[6].item()),
            ms=cuda_ms(lambda: kernels.band_route(*inp, SHARDS, cap), 10),
            plain_ms=cuda_ms(lambda: plain.band_route(*inp, SHARDS, cap),
                             3),
            bytes=16 * n + 16 * (SHARDS * cap + n) + 8)
        log("K15 {}: {} lanes, {} shards, room {}; max_abs_err {}; {} "
            "leftovers; {:.4f} ms, plain {:.4f}, bound {:.4f}".format(
                name, n, SHARDS, cap, err, runs[name]["n_left"],
                runs[name]["ms"], runs[name]["plain_ms"],
                bound_ms(runs[name]["bytes"])))
        del got, want
    if runs["hot"]["n_left"] == 0:
        fail("K15's hot chunk left no lane behind")
    r = runs["chunk"]
    record_kernel(rec, "band_route", max(x["err"] for x in runs.values()),
                  r["ms"], r["plain_ms"], r["bytes"], lanes=n, room=cap,
                  hot_ms=runs["hot"]["ms"],
                  hot_plain_ms=runs["hot"]["plain_ms"],
                  hot_leftovers=runs["hot"]["n_left"])
    # K16
    runs = {}
    for name, inp in (("chunk", lanes), ("hot", hot)):
        got = sorted_by_key(kernels.combine_lanes(*inp))
        want = plain.combine_lanes(*inp)
        m = int(want[3].item())
        err = max(max_abs_err(a, b[:m]) for a, b in zip(got[:3], want[:3]))
        err = max(err, abs(int(got[3].item()) - m))
        runs[name] = dict(
            err=err, distinct=m,
            ms=cuda_ms(lambda: kernels.combine_lanes(*inp), 10),
            plain_ms=cuda_ms(lambda: plain.combine_lanes(*inp), 3),
            bytes=32 * n + 8)
        log("K16 {}: {} lanes, {} distinct; max_abs_err {}; {:.4f} ms, "
            "plain {:.4f}, bound {:.4f}".format(
                name, n, m, err, runs[name]["ms"], runs[name]["plain_ms"],
                bound_ms(runs[name]["bytes"])))
        if name == "chunk":
            distinct = tuple(x[:m] for x in want[:3])
        del got, want
    r = runs["chunk"]
    record_kernel(rec, "combine_lanes",
                  max(x["err"] for x in runs.values()), r["ms"],
                  r["plain_ms"], r["bytes"], lanes=n,
                  distinct=r["distinct"], hot_ms=runs["hot"]["ms"],
                  hot_plain_ms=runs["hot"]["plain_ms"])
    # K17 and K3t against the phase-4 table
    table = Countgraph.load(ct, device=dev).storage
    geom, T = table._geom, len(table.get_tablesizes())
    m = distinct[0].numel()
    runs = {}
    for name, base in (("virgin", None), ("phase-4 .ct", table.table)):
        out = {}
        for side, fns in (("kernel", kernels), ("plain", plain)):
            claim = torch.full_like(table.table, -1)
            fns.claim_scatter(*distinct, *geom, claim)
            n_new = torch.zeros(1, dtype=torch.int64, device=dev)
            fns.claim_count(*distinct, *geom, claim, base, n_new)
            out[side] = (claim, n_new)
        err = max(max_abs_err(out["kernel"][0], out["plain"][0]),
                  max_abs_err(out["kernel"][1], out["plain"][1]))
        claim, n_new = out["kernel"]
        del out
        times = {}
        for side, fns, reps in (("kernel", kernels, 10), ("plain", plain, 3)):
            times[side] = (
                cuda_ms(lambda: fns.claim_scatter(*distinct, *geom, claim),
                        reps),
                cuda_ms(lambda: fns.claim_count(*distinct, *geom, claim,
                                                base, n_new), reps))
        nbytes = (16 * m + 4 * T * m) + (16 * m + 4 * T * m + 8 +
                                         (0 if base is None else 4 * T * m))
        runs[name] = dict(err=err, new=int(n_new.item()), times=times,
                          bytes=nbytes)
        log("K17 {}: {} distinct lanes, {} tables; max_abs_err {}; claims "
            "{:.4f} ms + count {:.4f} ms, plain {:.4f} + {:.4f}; bound "
            "{:.4f}".format(name, m, T, err, *times["kernel"],
                            *times["plain"], bound_ms(nbytes)))
        del claim
    r = runs["phase-4 .ct"]
    record_kernel(rec, "claim_news", max(x["err"] for x in runs.values()),
                  sum(r["times"]["kernel"]), sum(r["times"]["plain"]),
                  r["bytes"], lanes=m, scatter_ms=r["times"]["kernel"][0],
                  count_ms=r["times"]["kernel"][1],
                  virgin_ms=sum(runs["virgin"]["times"]["kernel"]),
                  virgin_plain_ms=sum(runs["virgin"]["times"]["plain"]))
    # K3t on the chunk's hashes (part of their bins repeat, so some
    # sectors come from L2) and on 2**23 distinct random keys (each bin a
    # random 32-byte sector from device memory), beside the library
    # gather of precomputed bins, table[idx]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    hi, lo = torch.randint(0, 1 << 32, (2, n), generator=g, device=dev,
                           dtype=torch.int64)
    k3t = {}
    for name, keys in (("chunk", hashes), ("distinct", (hi << 32) | lo)):
        k3t[name] = gather_timed(
            n * T,
            lambda keys=keys: kernels.sketch_get_tables(table.table, keys,
                                                        *geom),
            lambda keys=keys: plain.sketch_get_tables(table.table, keys,
                                                      *geom),
            plain._bins(keys, *geom[:2]), table.table)
        log("K3t {}: {} keys, {} tables; {}".format(name, n, T, json.dumps(
            k3t[name])))
    a, b = k3t["chunk"], k3t["distinct"]
    record_kernel(
        rec, "sketch_get_tables", max(a["err"], b["err"]), a["ms"],
        a["plain_ms"], 8 * n + 8 * T * n, library_ms=a["library_ms"],
        keys=n, sectors_per_s=a["sectors_per_s"], distinct_ms=b["ms"],
        distinct_library_ms=b["library_ms"],
        distinct_sectors_per_s=b["sectors_per_s"],
        **rec["alone"]["sketch_get_tables"])
    del hi, lo, table, lanes, hot, distinct, hashes
    gc.collect()
    torch.cuda.empty_cache()
    # K10's split on phase 7's star
    Tn, s7, d7 = star
    src = s7.to(dev, torch.int32).contiguous()
    dst = d7.to(dev, torch.int32).contiguous()
    lab = torch.arange(Tn, dtype=torch.int32, device=dev)
    m_k = kernels.cc_relax(lab, src, dst)
    m_p = plain.cc_relax(lab, src, dst)
    flags = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    j_k = kernels.cc_jump(m_k, lab, flags[0])
    j_p = plain.cc_jump(m_p, lab, flags[1])
    E = src.numel()
    record_kernel(rec, "cc_relax", max_abs_err(m_k, m_p),
                  cuda_ms(lambda: kernels.cc_relax(lab, src, dst), 10),
                  cuda_ms(lambda: plain.cc_relax(lab, src, dst), 3),
                  8 * E + 8 * Tn, T=Tn, E=E)
    record_kernel(rec, "cc_jump", max(max_abs_err(j_k, j_p),
                                      max_abs_err(*flags)),
                  cuda_ms(lambda: kernels.cc_jump(m_k, lab, flags[0]), 10),
                  cuda_ms(lambda: plain.cc_jump(m_p, lab, flags[1]), 3),
                  12 * Tn + 4, T=Tn)
    torch.cuda.empty_cache()


def sharded_consume(fa, spec, dev):
    """ShardedDeferredConsumer over a data=1, shard=SHARDS mesh of the
    card, fed by the native loader with `fa`: (consumer, mesh, finish()'s
    (delta, n_unique, n_consumed, candidates))."""
    from khmer_tpu_torch.hashtable import CHUNK
    from khmer_tpu_torch.native import NativeChunkReader
    from khmer_tpu_torch.parallel import ShardedDeferredConsumer, make_mesh

    mesh = make_mesh([dev] * SHARDS)
    c = ShardedDeferredConsumer(spec, K, "2bit", mesh=mesh, chunk=CHUNK,
                                from_codes=True, use_bigcount=True)
    with NativeChunkReader(fa, K, CHUNK) as reader:
        for codes, mask in reader:
            c.add_chunk(codes, mask)
    out = c.finish(virgin=True)
    sync(dev)
    return c, mesh, out


def dist_worker(port, pid, fa, out):
    """One of phase 13 (d)'s two processes: distributed_count of the one
    file `fa` (process 0's; process 1 dispatches empty chunks), over
    NCCL where the machine has a card for each process, else over gloo
    with both on cuda:0; process 0 saves the result."""
    import torch
    import torch.distributed as dist

    from khmer_tpu_torch.hashtable import CHUNK
    from khmer_tpu_torch.ops.sketch_ops import SketchSpec
    from khmer_tpu_torch.parallel import distributed_count, initialize
    from khmer_tpu_torch.primes import get_n_primes_near_x

    backend = initialize("127.0.0.1:" + port, 2, pid,
                         "nccl" if torch.cuda.device_count() >= 2 else "gloo")
    spec = SketchSpec("byte", tuple(get_n_primes_near_x(4, DIST_TABLE)))
    t0 = time.perf_counter()
    # one file: shard_files_for_host gives it to process 0
    res = distributed_count([fa], spec, K, chunk=CHUNK, use_bigcount=True)
    wall = time.perf_counter() - t0
    if pid == 0:
        np.savez(out, table=res.merged_table(),
                 uniq=np.int64(res.n_unique_kmers()),
                 consumed=np.int64(res.n_consumed), wall=np.float64(wall),
                 backend=np.array(backend),
                 devices=np.array([str(d) for d in res.mesh.devices]))
    dist.destroy_process_group()
    torch.cuda.synchronize()


def run_distributed(card, dev, tmp):
    """Phase 13 (d): distributed_count over two processes on the first
    QF_READS phase-5 reads (one file: process 1 idles), -k 20 -N 4 -x
    DIST_TABLE, against a serial consume on the card."""
    import socket

    from khmer_tpu_torch import Countgraph

    fa = os.path.join(tmp, "qf.fa")
    out = os.path.join(tmp, "dist.npz")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dist-worker", port, str(pid), fa, out],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    results = []
    try:
        for p in procs:
            results.append((p.communicate(timeout=300), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(rc != 0 for _, rc in results):
        fail("a distributed_count process failed:\n" + "\n".join(
            "process {} exited {}:\n{}\n{}".format(pid, rc, o[-2000:],
                                                   e[-3000:])
            for pid, ((o, e), rc) in enumerate(results)))
    got = np.load(out)
    g = Countgraph(K, DIST_TABLE, 4, device=dev)
    g.set_use_bigcount(True)
    _, n_consumed = g.consume_seqfile(fa)
    serial = g.storage.table.cpu().numpy().view(np.uint32)
    if not np.array_equal(got["table"], serial) or \
            int(got["uniq"]) != g.n_unique_kmers() or \
            int(got["consumed"]) != n_consumed:
        fail("distributed_count differs from the serial consume")
    log("phase 13 (d): distributed_count over 2 processes ({} backend, "
        "shards on {} in process 0; process 1 had no file) on {} reads, "
        "-N 4 -x {:.0e}: merged table, n_unique {} and n_consumed {} equal "
        "to a serial consume on the card; the count {:.3f} s, the "
        "processes' wall {:.3f} s with start-up [{}]".format(
            str(got["backend"]), list(got["devices"]), QF_READS,
            DIST_TABLE, int(got["uniq"]), int(got["consumed"]),
            float(got["wall"]), wall, card))
    return str(got["backend"])


def run_sharded(card, dev, tmp, reads_fa, ct):
    """Phase 13 (b)-(d): the sharded consume of the phase-4 file (kernels,
    stage times, profile, plain versions) against the serial table; the
    sharded query; do_partition_device over the mesh on phase 7's graph;
    distributed_count over two processes.  Returns the path's
    launches."""
    import torch

    from khmer_tpu_torch import (Countgraph, Nodegraph, SubsetPartition,
                                 kernels)
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.ops import deferred
    from khmer_tpu_torch.parallel import make_mesh, make_sharded_query
    from khmer_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    with open(ct + ".info") as f:
        ct_unique = int([ln for ln in f if ln.startswith(
            "Total number of unique k-mers:")][0].split(":")[1])
    serial = Countgraph(K, TABLE_SIZE, 4, device=dev)
    serial.set_use_bigcount(True)
    n_reads, n_consumed = serial.consume_seqfile(reads_fa)
    spec = serial.storage.spec
    _, hashes = shard_lanes(reads_fa, dev)
    hashes = hashes[:SHARD_QUERY].contiguous()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    c, mesh, (delta, n_unique, n_cons, cands) = sharded_consume(
        reads_fa, spec, dev)
    wall = time.perf_counter() - t0
    counts = make_sharded_query(spec, mesh, 65535)(c.tables, hashes)
    sync(dev)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stats = dict(sharded.LAST_CONSUME_STATS)
    want = kernels.sketch_get(serial.storage.table, hashes,
                              *serial.storage._geom, 65535)
    if not torch.equal(delta, serial.storage.table):
        fail("the sharded delta differs from the serial table")
    if (n_unique, n_cons) != (serial.n_unique_kmers(), n_consumed) or \
            n_unique != ct_unique:
        fail("sharded n_unique {} / n_consumed {} differ from the serial "
             "{} / {} (phase 4's .ct: {})".format(
                 n_unique, n_cons, serial.n_unique_kmers(), n_consumed,
                 ct_unique))
    if not torch.equal(counts, want):
        fail("the sharded query differs from K3 on the serial table")
    if cands != serial.storage.bigcount_candidates:
        fail("the sharded bigcount candidates differ from the serial ones")
    missing = [k for k in SLICE7A_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the sharded path: {}".format(missing))
    log("phase 13 (b): ShardedDeferredConsumer over a data=1, shard={} mesh "
        "on {} ({} reads of the phase-4 file, -k 20 -N 4 -x 1e8): delta == "
        "the serial table, n_unique {} == phase 4's .ct, n_consumed {}, "
        "the query of {} hashes == K3 on the serial table; wall {:.3f} s "
        "({:.2f} Mbases/s); peak device memory {} bytes = {:.3f} GiB ({} "
        "held before); {} [{}]".format(
            SHARDS, dev, n_reads, n_unique, n_cons, SHARD_QUERY, wall,
            n_cons / wall / 1e6, peak, peak / 2 ** 30, held,
            json.dumps(stats), card))
    log("phase 13 launches: {}".format(json.dumps(launches)))
    del c, delta, counts
    gc.collect()
    torch.cuda.empty_cache()
    deferred.reset_stage_times()
    deferred.enable_timing(True)
    try:
        t0 = time.perf_counter()
        sharded_consume(reads_fa, spec, dev)
        t_timed = time.perf_counter() - t0
    finally:
        deferred.enable_timing(False)
    log("phase 13 stage ms (each stage synchronised; wall {:.3f} s): {} "
        "[{}]".format(t_timed, json.dumps(
            {k: round(v * 1e3, 3) for k, v in deferred.STAGE_TIMES.items()}),
            card))
    gc.collect()
    torch.cuda.empty_cache()
    device_share("sharded consume", lambda: sharded_consume(reads_fa, spec,
                                                            dev), card)
    gc.collect()
    torch.cuda.empty_cache()
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        t0 = time.perf_counter()
        pc, _, (pdelta, pu, pn, pcands) = sharded_consume(reads_fa, spec,
                                                          dev)
        t_plain = time.perf_counter() - t0
    if not torch.equal(pdelta, serial.storage.table) or \
            (pu, pn, pcands) != (n_unique, n_cons, cands):
        fail("the sharded consume through the plain versions differs")
    log("phase 13 plain-version run: the same delta, n_unique and "
        "n_consumed; wall {:.3f} s [{}]".format(t_plain, card))
    del pc, pdelta, serial
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the sharded CC on phase 7's graph
    base = os.path.join(tmp, "p7", "kernels", "g")
    ng = Nodegraph.load(base, device=dev)
    ng.load_tagset(base + ".tagset")
    single = SubsetPartition(ng)
    sync(dev)
    t0 = time.perf_counter()
    single.do_partition_device()
    sync(dev)
    t_single = time.perf_counter() - t0
    kernels.reset_launches()
    meshed = SubsetPartition(ng)
    t0 = time.perf_counter()
    meshed.do_partition_device(mesh=make_mesh([dev] * SHARDS))
    sync(dev)
    t_mesh = time.perf_counter() - t0
    for name in ("cc_relax", "cc_jump"):
        launches[name] = kernels.LAUNCHES[name]
    if partition_sets(meshed) != partition_sets(single) or \
            meshed.count_partitions() != single.count_partitions():
        fail("do_partition_device over the mesh differs from one device")
    if dev.type == "cuda" and not (launches["cc_relax"] and
                                   launches["cc_jump"]):
        fail("do_partition_device over the mesh launched no K10 relax or "
             "jump")
    log("phase 13 (c): do_partition_device(mesh of {} shards) == "
        "do_partition_device on phase 7's graph ({} partitions, {} tags, "
        "{} edges, {} blocks of 4 rounds); {:.3f} s against {:.3f} s; K10 "
        "relax {} and jump {} launches [{}]".format(
            SHARDS, len(partition_sets(meshed)), meshed.device_stats["tags"],
            meshed.device_stats["edges"], meshed.device_stats["calls"],
            t_mesh, t_single, launches["cc_relax"], launches["cc_jump"],
            card))
    del ng, single, meshed
    gc.collect()
    torch.cuda.empty_cache()
    run_distributed(card, dev, tmp)
    log("phase 13: {:.1f} s".format(time.perf_counter() - t_phase))
    return launches


# ---------------------------------------------------------------------------
# phase 14: slice 15, the bin-sharded table
# ---------------------------------------------------------------------------


def edge_keys(spec, bounds, n, seed):
    """Keys whose bin in one table is each piece's first and last bin and
    the last table's last bin (one key a bin, in the table holding it; the
    last piece ends at the spare bin, which no key reaches), as an int64
    tensor of at most n keys on the CPU."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for g in [b for lo, hi in bounds for b in (lo, hi - 1)] + \
            [spec.total_bins - 1]:
        for p, off in zip(spec.tablesizes, spec.bin_offsets):
            if off <= g < off + p:
                # below 2**64 for any table of fewer than 2**34 bins
                out.append((g - off) + p * int(rng.integers(1, 1 << 30)))
    out = np.array(out[:n], np.uint64)
    return torch.from_numpy(out.view(np.int64))


def check_binshard_kernels(seed, dev, reads_fa, ct, rec):
    """Phase 14 (a): K18, K19 and K20 against their plain versions on the
    card, bit for bit, on each of BINSHARD_PIECES pieces of the phase-4
    .ct with the first 2**23-lane chunk of the phase-4 file (lane index
    as first position, as add_lanes gives them; edge keys first), with
    CUDA-event times of piece 0 and the bytes-once bound."""
    import torch

    from khmer_tpu_torch import Countgraph, kernels
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.parallel import make_mesh

    log("phase 14 (a): K18, K19 and K20 on the first 2**23-lane chunk of "
        "the phase-4 file (edge keys first) on each of {} pieces of the "
        "phase-4 .ct".format(BINSHARD_PIECES))
    (keys, wgts, firsts), _ = shard_lanes(reads_fa, dev)
    st = Countgraph.load(ct, device=dev).storage
    lay = st.shard_table(make_mesh([dev] * BINSHARD_PIECES))
    spec = st.spec
    edges = edge_keys(spec, lay.bounds, keys.numel(), seed).to(dev)
    keys[:edges.numel()] = edges
    wgts[:edges.numel()] = 1
    n, T = keys.numel(), spec.n_tables
    live = (keys != -1) & (wgts != 0)
    cap = n
    err = dict.fromkeys(("owned_claims", "owned_add", "owned_get"), 0)
    edge_hits = 0
    for j, (piece, lo, geom) in enumerate(lay.parts()):
        out = {}
        for side, fns in (("kernel", kernels), ("plain", plain)):
            p = piece.clone()
            flags = torch.zeros(n, dtype=torch.int32, device=dev)
            cand = torch.zeros(cap, dtype=torch.int64, device=dev)
            count = torch.zeros(1, dtype=torch.int32, device=dev)
            fns.owned_claims(keys, wgts, firsts, p, lo, *geom, flags, False,
                             cand, count)
            m = int(count.item())
            cands = torch.sort(cand[:min(m, cap)]).values
            same = torch.equal(p, piece)
            fns.owned_add(keys, wgts, p, lo, *geom)
            got = fns.owned_get(keys, p, lo, *geom)
            out[side] = (flags, cands, m, same, p, got)
            del p
        (kf, kc, km, ks, kp, kg), (pf, pc, pm, ps, pp, pg) = \
            out["kernel"], out["plain"]
        e18 = max(max_abs_err(kf, pf), max_abs_err(kc, pc), abs(km - pm),
                  0 if ks and ps else 1)
        err["owned_claims"] = max(err["owned_claims"], e18)
        err["owned_add"] = max(err["owned_add"], max_abs_err(kp, pp))
        err["owned_get"] = max(err["owned_get"], max_abs_err(kg, pg))
        b, own = plain._owned(keys[:edges.numel()], piece, lo, *geom[:2])
        edge_hits += int((own & ((b == 0) | (b == piece.numel() - 1) |
                                 (b + lo == spec.total_bins - 1))).sum())
        log("piece {} [{}, {}): flags {} won, {} candidates; K18 err {}, "
            "K19 {}, K20 {}".format(
                j, lo, lo + piece.numel(), int(kf.sum()), km, e18,
                max_abs_err(kp, pp), max_abs_err(kg, pg)))
        del out, kf, kc, kp, kg, pf, pc, pp, pg
    if edge_hits < 2 * BINSHARD_PIECES:
        fail("phase 14 (a): the edge keys hit {} edge bins".format(
            edge_hits))
    piece, lo, geom = lay.parts()[0]
    _, own = plain._owned(keys, piece, lo, *geom[:2])
    owned_all = int(own.sum())
    owned = int((own & live[None, :]).sum())
    del own
    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    cand = torch.zeros(cap, dtype=torch.int64, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    p = piece.clone()
    times = {}
    for side, fns, reps in (("kernel", kernels, 10), ("plain", plain, 3)):
        times[side] = (
            cuda_ms(lambda: fns.owned_claims(keys, wgts, firsts, p, lo,
                                             *geom, flags, False, cand,
                                             count), reps),
            cuda_ms(lambda: fns.owned_add(keys, wgts, p, lo, *geom), reps),
            cuda_ms(lambda: fns.owned_get(keys, p, lo, *geom), reps))
    del p
    # bytes once: the lanes in (key, weight, first), the flags out and
    # each owned bin of a live lane in the claims and the piece (K18); the
    # lanes and each owned bin in and out (K19); the keys, each owned bin
    # and the minima out (K20)
    nbytes = (16 * n + 4 * n + 8 * owned, 12 * n + 8 * owned,
              8 * n + 4 * owned_all + 4 * n)
    # K20 and the owned sectors it reads a second
    k20 = gather_timed(owned_all,
                       lambda: kernels.owned_get(keys, piece, lo, *geom),
                       lambda: plain.owned_get(keys, piece, lo, *geom))
    log("K20 on piece 0: {} lanes, {} owned bins; {}".format(
        n, owned_all, json.dumps(k20)))
    extra = {"owned_get": dict(
        sectors_per_s=owned_all / (times["kernel"][2] * 1e-3),
        **rec["alone"]["owned_get"])}
    for i, name in enumerate(("owned_claims", "owned_add", "owned_get")):
        record_kernel(rec, name, max(err[name], k20["err"] if i == 2 else 0),
                      times["kernel"][i], times["plain"][i], nbytes[i],
                      lanes=n, pieces=BINSHARD_PIECES,
                      piece_bins=[hi - lo for lo, hi in lay.bounds],
                      owned_bins=owned if i < 2 else owned_all,
                      **extra.get(name, {}))
    del st, lay, keys, wgts, firsts
    gc.collect()
    torch.cuda.empty_cache()


def binshard_countgraph(dev, shards=BINSHARD_PIECES):
    """A -k 20 -N 4 -x 1e8 Countgraph with bigcount on the card, its table
    cut into `shards` pieces of the card (0: whole)."""
    from khmer_tpu_torch import Countgraph
    from khmer_tpu_torch.parallel import make_mesh

    g = Countgraph(K, TABLE_SIZE, 4, device=dev)
    g.set_use_bigcount(True)
    lay = g.storage.shard_table(make_mesh([dev] * shards)) if shards \
        else None
    return g, lay


def saved_bytes(g, path):
    g.save(path)
    with open(path, "rb") as f:
        return f.read()


@contextlib.contextmanager
def lanes_logged(module, name, lanes):
    """Append the lanes (first argument's numel) of every call of
    module.name in the body to `lanes`."""
    real = getattr(module, name)

    def call(keys, *a, **kw):
        lanes.append(keys.numel())
        return real(keys, *a, **kw)

    with mock.patch.object(module, name, call):
        yield


def run_binshard(card, dev, tmp, reads_fa, ct):
    """Phase 14 (b) and (d): the bin-sharded Countgraph's consume of the
    phase-4 file against phase 4's serial table (its timed .ct, which the
    deferred counter made on the whole table), and the 4-piece Nodegraph's
    tagging and partitions against phase 7's graph, with K20's lanes per
    call.  Returns the path's launches, (b)'s and (d)'s."""
    import torch

    from khmer_tpu_torch import Countgraph, Nodegraph, SubsetPartition
    from khmer_tpu_torch import kernels
    from khmer_tpu_torch.kernels import plain
    from khmer_tpu_torch.ops import deferred
    from khmer_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    with open(ct + ".info") as f:
        ct_unique = int([ln for ln in f if ln.startswith(
            "Total number of unique k-mers:")][0].split(":")[1])
    timed_ct = os.path.join(tmp, "timed.ct")
    with open(timed_ct, "rb") as f:
        want = f.read()
    serial = Countgraph.load(timed_ct, device=dev)
    want_raw, want_occ = serial.storage.raw_bytes(), serial.n_occupied()
    del serial
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    # K20's lanes a call, over the runs whose launches phase 14 counts
    k20_lanes = []
    k20_log = contextlib.ExitStack()
    k20_log.enter_context(lanes_logged(kernels, "owned_get", k20_lanes))
    t0 = time.perf_counter()
    g, lay = binshard_countgraph(dev)
    n_reads, n_cons = g.consume_seqfile(reads_fa)
    sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = saved_bytes(g, os.path.join(tmp, "binshard.ct"))
    if got != want:
        fail("the bin-sharded consume's .ct differs from phase 4's")
    if not np.array_equal(g.storage.raw_bytes(), want_raw) or \
            g.n_occupied() != want_occ or g.n_unique_kmers() != ct_unique:
        fail("the bin-sharded consume's raw bytes, n_occupied {} or "
             "n_unique {} differ from phase 4's ({}, {})".format(
                 g.n_occupied(), g.n_unique_kmers(), want_occ, ct_unique))
    # the consume, its save and the reads
    launches = dict(kernels.LAUNCHES)
    k20_log.close()
    missing = [k for k in ("owned_claims", "owned_add", "combine_lanes",
                           "hash2bit_canonical") if launches[k] == 0]
    if missing:
        fail("kernels not launched by the bin-sharded consume: {}".format(
            missing))
    log("phase 14 (b): shard_table over {} shards of {} ({}), then "
        "consume_seqfile of the phase-4 file ({} reads, {} k-mers): .ct "
        "(bigcount section included), raw bytes, n_occupied {} and "
        "n_unique {} == phase 4's serial table; wall {:.3f} s ({:.2f} "
        "Mbases/s); piece bytes {}; peak device memory {} bytes = {:.3f} "
        "GiB ({} held before) [{}]".format(
            BINSHARD_PIECES, dev, lay, n_reads, n_cons, want_occ, ct_unique,
            wall, n_reads * 100 / wall / 1e6,
            [p.numel() * 4 for p in lay.pieces], peak, peak / 2 ** 30, held,
            card))
    log("phase 14 (b) launches: {}".format(json.dumps(launches)))
    del g, lay
    gc.collect()
    torch.cuda.empty_cache()
    deferred.reset_stage_times()
    deferred.enable_timing(True)
    try:
        t0 = time.perf_counter()
        binshard_countgraph(dev)[0].consume_seqfile(reads_fa)
        t_timed = time.perf_counter() - t0
    finally:
        deferred.enable_timing(False)
    log("phase 14 stage ms (each stage synchronised; wall {:.3f} s): {} "
        "[{}]".format(t_timed, json.dumps(
            {k: round(v * 1e3, 3) for k, v in deferred.STAGE_TIMES.items()}),
            card))
    gc.collect()
    torch.cuda.empty_cache()
    device_share("bin-sharded consume",
                 lambda: binshard_countgraph(dev)[0].consume_seqfile(
                     reads_fa), card)
    gc.collect()
    torch.cuda.empty_cache()
    with mock.patch.multiple(kernels, **{name: getattr(plain, name)
                                         for name in kernels.KERNELS}):
        t0 = time.perf_counter()
        pg = binshard_countgraph(dev)[0]
        pg.consume_seqfile(reads_fa)
        sync(dev)
        t_plain = time.perf_counter() - t0
        if saved_bytes(pg, os.path.join(tmp, "binshard_plain.ct")) != want:
            fail("the bin-sharded consume through the plain versions "
                 "differs")
    log("phase 14 plain-version run: the same .ct; wall {:.3f} s [{}]"
        .format(t_plain, card))
    del pg
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the 4-piece Nodegraph against phase 7's graph
    base = os.path.join(tmp, "p7", "kernels", "g")
    ng = Nodegraph.load(base, device=dev)
    ng.load_tagset(base + ".tagset")
    t0 = time.perf_counter()
    whole_raw = ng.storage.raw_bytes()
    t_wraw = time.perf_counter() - t0
    mesh = make_mesh([dev] * BINSHARD_PIECES)
    kernels.reset_launches()
    k20_log.enter_context(lanes_logged(kernels, "owned_get", k20_lanes))
    t0 = time.perf_counter()
    sg = Nodegraph(PARTITION_K, TABLE_SIZE, 4, device=dev)
    sg.storage.shard_table(mesh)
    sg.consume_seqfile_and_tag(os.path.join(tmp, "p7", "reads.fa"))
    sync(dev)
    t_tag = time.perf_counter() - t0
    # the save's stream, packed a piece at a time on the card (K14, bit
    # kind), against the whole graph's; raw_bytes returns host bytes
    t0 = time.perf_counter()
    sharded_raw = sg.storage.raw_bytes()
    t_sraw = time.perf_counter() - t0
    if sg.all_tags != ng.all_tags or not np.array_equal(sharded_raw,
                                                        whole_raw):
        fail("the 4-piece Nodegraph's tags or bytes differ from phase 7's")
    del sharded_raw, whole_raw
    seeds = sorted(ng.all_tags)[:3]
    for seed in seeds:
        a = SubsetPartition(ng).find_all_tags(seed).tagged_kmers
        b = SubsetPartition(sg).find_all_tags(seed).tagged_kmers
        if set(a) != set(b):
            fail("find_all_tags differs on the 4-piece Nodegraph")
    t0 = time.perf_counter()
    meshed = SubsetPartition(sg)
    meshed.do_partition_device(mesh=mesh)
    sync(dev)
    t_part = time.perf_counter() - t0
    for name in SOURCES:
        if name in kernels.LAUNCHES:
            launches[name] = launches.get(name, 0) + kernels.LAUNCHES[name]
    k20_log.close()
    single = SubsetPartition(ng)
    single.do_partition_device()
    if partition_sets(meshed) != partition_sets(single):
        fail("the 4-piece Nodegraph's partitions differ from phase 7's")
    missing = [k for k in SLICE15_PATH if launches[k] == 0]
    if missing:
        fail("kernels not launched by the bin-sharded path: {}".format(
            missing))
    log("phase 14 (d): a {}-piece Nodegraph (-k {} -N 4 -x 1e8): "
        "consume_seqfile_and_tag of phase 7's reads {:.3f} s, {} tags and "
        "the raw bytes == phase 7's graph (raw_bytes {:.4f} s a piece at "
        "a time, the whole graph's {:.4f} s); find_all_tags from {} seeds "
        "equal; do_partition_device(mesh) {:.3f} s, {} partitions == the "
        "whole graph's [{}]".format(
            BINSHARD_PIECES, PARTITION_K, t_tag, len(sg.all_tags), t_sraw,
            t_wraw, len(seeds), t_part, len(partition_sets(meshed)), card))
    log("phase 14 launches ((b) and (d)): {}".format(json.dumps(
        {k: launches[k] for k in SLICE15_PATH})))
    calls = [m for m in k20_lanes if m]
    if len(calls) != launches["owned_get"]:
        fail("phase 14 logged {} K20 calls with lanes, {} launches".format(
            len(calls), launches["owned_get"]))
    by_pow2 = {}
    for m in calls:
        b = 1 << (m - 1).bit_length()
        by_pow2[b] = by_pow2.get(b, 0) + 1
    log("phase 14 K20 lanes per call ((b)'s save and (d)): {} launches, "
        "{} lanes in all, median {}, min {}, max {}; calls by lanes up to "
        "a power of two: {}".format(
            len(calls), sum(calls), statistics.median(calls), min(calls),
            max(calls), json.dumps(dict(sorted(by_pow2.items())))))
    del ng, sg, meshed, single
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 14: {:.1f} s".format(time.perf_counter() - t_phase))
    return launches


# ---------------------------------------------------------------------------
# --ab OTHER: this checkout against another on the same card
# ---------------------------------------------------------------------------

AB_LANES = (1 << 16, 1 << 23)  # a short call (phase 14's are ~6e4) and 2**23
AB_KERNELS = ("sketch_get_tables", "owned_get")
AB_CONSUMES = 3  # timed, after one untimed


def ptxas_report(build, kernels=AB_KERNELS, sources=("sketch", "binshard")):
    """ptxas's resource lines (registers, stack frame, spills) of the
    entry functions of `kernels` in a checkout's csrc sources, compiled
    with its own nvcc flags (`build` is its kernels._build)."""
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    lines = []
    for src in sources:
        proc = subprocess.run(
            [build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             os.devnull, os.path.join(build.CSRC, src + ".cu")],
            capture_output=True, text=True, check=True)
        keep = False
        for ln in proc.stderr.splitlines():
            if "Compiling entry function" in ln:
                keep = any(k in ln for k in kernels)
            if keep:
                lines.append(src + ".cu: " + ln.strip())
    return lines


def ab_worker(checkout, reads_fa, lanes, seed, ptxas):
    """One run of --ab, with the checkout's khmer_tpu_torch: K3t and K20
    at each number of lanes (a wrapper call by CUDA events; the kernel
    alone by torch.profiler; a digest of the output) on a 4 x ~1e8-bin
    table of random bins and distinct random keys (K20 on piece 0 of
    the table cut in BINSHARD_PIECES as Storage.shard_table cuts it),
    then phase 4's consume of reads_fa (one untimed, AB_CONSUMES timed,
    each into a new table; the peak device memory above the table; the
    .ct's sha256).  Prints one JSON line."""
    sys.path.insert(0, checkout)
    import torch

    import khmer_tpu_torch
    from khmer_tpu_torch import Countgraph, kernels
    from khmer_tpu_torch.kernels import _build
    from khmer_tpu_torch.ops.sketch_ops import SketchSpec
    from khmer_tpu_torch.primes import get_n_primes_near_x
    from khmer_tpu_torch.storage import piece_bounds

    where = os.path.dirname(os.path.dirname(os.path.abspath(
        khmer_tpu_torch.__file__)))
    if os.path.realpath(where) != os.path.realpath(checkout):
        fail("imported khmer_tpu_torch from " + where)
    out = dict(checkout=checkout, ptxas=ptxas_report(_build) if ptxas
               else [], kernels=[])
    _build.function("khmer_sketch_get")
    dev = torch.device("cuda")
    spec = SketchSpec("byte", get_n_primes_near_x(4, TABLE_SIZE))
    geom = spec.geometry(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_bins = spec.total_bins + 1
    table = torch.randint(-(1 << 31), 1 << 31, (n_bins,), generator=g,
                          device=dev, dtype=torch.int64).to(torch.int32)
    lo0, hi0 = piece_bounds(spec, n_bins, BINSHARD_PIECES)[0]
    piece = table[lo0:hi0].clone()
    hi, lo = torch.randint(0, 1 << 32, (2, max(lanes)), generator=g,
                           device=dev, dtype=torch.int64)
    keys_all = (hi << 32) | lo
    del hi, lo
    for n in lanes:
        keys = keys_all[:n]
        for name, fn in (
                ("sketch_get_tables",
                 lambda: kernels.sketch_get_tables(table, keys, *geom)),
                ("owned_get",
                 lambda: kernels.owned_get(keys, piece, lo0, *geom))):
            out["kernels"].append(dict(
                name=name, lanes=n,
                ms=cuda_ms(fn, 10, inner=5 if n >= 1 << 20 else 50),
                alone_ms=kernel_alone_ms(fn, name + "_kernel"),
                digest=hashlib.sha256(
                    fn().cpu().numpy().tobytes()).hexdigest()[:16]))
    del table, piece, keys_all, keys
    gc.collect()
    torch.cuda.empty_cache()
    walls, peaks = [], []
    for _ in range(1 + AB_CONSUMES):
        cg = Countgraph(K, TABLE_SIZE, 4, device=dev)
        cg.set_use_bigcount(True)
        sync(dev)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cg.consume_seqfile(reads_fa)
        nu = cg.n_unique_kmers()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - held)
    with tempfile.TemporaryDirectory(prefix="khmer_ab_") as tmp:
        sha = hashlib.sha256(saved_bytes(
            cg, os.path.join(tmp, "t.ct"))).hexdigest()
    out["consume"] = dict(untimed_s=walls[0], s=walls[1:], peak_bytes=peaks,
                          table_bytes=held, n_unique=nu, ct_sha256=sha)
    print(json.dumps(out))


def run_ab(other, lanes, seed):
    """--ab: K3t, K20 and phase 4's consume of this checkout against
    `other`'s (another version of this repository, say the parent commit
    unpacked with git archive), each run in a process of its own in the
    order other, this, this, other, so that a drift of the card shows as
    a difference between one checkout's two runs.  Fails if the outputs
    differ between the checkouts."""
    here = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    log("card: " + card)
    runs = []
    with tempfile.TemporaryDirectory(prefix="khmer_ab_") as tmp:
        fa = os.path.join(tmp, "reads.fa")
        make_reads(fa, seed)
        for i, (name, path) in enumerate((
                ("other", os.path.abspath(other)), ("this", here),
                ("this", here), ("other", os.path.abspath(other)))):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--ab-worker",
                 path, fa, "--seed", str(seed), "--lanes",
                 *map(str, lanes)] + (["--ptxas"] if i < 2 else []),
                capture_output=True, text=True, cwd=path)
            if proc.returncode:
                print(proc.stderr, file=sys.stderr)
                fail("the {} checkout's run failed".format(name))
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            r["name"] = name
            runs.append(r)
            for ln in r["ptxas"]:
                log("ptxas {}: {}".format(name, ln))
            for k in r["kernels"]:
                log("{:5s} {} lanes {}: {:.4f} ms a call, alone {} ms; "
                    "digest {} [{}]".format(name, k["name"], k["lanes"],
                                            k["ms"], k["alone_ms"],
                                            k["digest"], card))
            c = r["consume"]
            log("{:5s} phase-4 consume: {} s (untimed first {:.3f} s); "
                "peak device memory above the {}-byte table {} bytes; "
                "n_unique {}; .ct sha256 {} [{}]".format(
                    name, c["s"], c["untimed_s"], c["table_bytes"],
                    c["peak_bytes"], c["n_unique"], c["ct_sha256"], card))
    outputs = {json.dumps([[k["name"], k["lanes"], k["digest"]]
                           for k in r["kernels"]] +
                          [r["consume"]["n_unique"],
                           r["consume"]["ct_sha256"]]) for r in runs}
    if len(outputs) != 1:
        fail("the checkouts' outputs differ")
    log("outputs identical across the checkouts")
    print(json.dumps({"card": card, "runs": runs}))


def _u64_numpy(t):
    return t.cpu().numpy().view(np.uint64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dist-worker", nargs=4, metavar=("PORT", "PID", "FA",
                                                       "OUT"),
                    help="run one process of phase 13 (d) and exit")
    ap.add_argument("--ab", metavar="OTHER_CHECKOUT",
                    help="time K3t, K20 and phase 4's consume of this "
                    "checkout against another's instead of the smoke")
    ap.add_argument("--ab-worker", nargs=2, metavar=("CHECKOUT", "FA"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--lanes", type=int, nargs="*", default=[],
                    help="with --ab, more numbers of lanes to time at")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card")
    if args.dist_worker:
        port, pid, fa, out = args.dist_worker
        dist_worker(port, int(pid), fa, out)
        return
    lanes = sorted(set(AB_LANES) | set(args.lanes))
    if args.ab_worker:
        ab_worker(*args.ab_worker, lanes, args.seed, args.ptxas)
        return
    if args.ab:
        run_ab(args.ab, lanes, args.seed)
        return

    from khmer_tpu_torch.kernels import _build
    from khmer_tpu_torch.native import get_lib

    card = card_line()
    log("card: " + card)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.function("khmer_sketch_get")
    get_lib()
    log("build: {:.1f} s (nvcc for {} sources in parallel, g++ loader)"
        .format(time.perf_counter() - t0, len(_build.SOURCES)))

    rec = check_kernels(args.seed, dev)
    with tempfile.TemporaryDirectory(prefix="khmer_smoke_") as tmp:
        launches, uniq4 = main_path(args.seed, card, dev, tmp)
        ct = os.path.join(tmp, "kernels", "reads.ct")
        check_save_kernels(args.seed, dev, ct, rec)
        reads_fa = os.path.join(tmp, "reads.fa")
        pairs_fa, head_fa = make_slice2_files(args.seed, tmp)
        check_slice2_kernels(args.seed, dev, ct, reads_fa, pairs_fa, rec)
        check_murmur_kernels(args.seed, dev, reads_fa, pairs_fa, rec)
        slice2 = run_slice2(card, dev, tmp, ct, pairs_fa, head_fa)
        murmur = run_murmur(card, dev, tmp, reads_fa, pairs_fa, uniq4)
        partition, star, _ = run_partition(card, dev, tmp, args.seed)
        check_cc_kernel(args.seed, dev, rec, star)
        check_cyclic_kernels(args.seed, dev, reads_fa, pairs_fa, rec)
        small = run_small_count(card, dev, tmp, reads_fa, pairs_fa, uniq4)
        check_filter_kernel(dev, reads_fa, ct, rec)
        slice10 = run_slice10(card, dev, tmp, reads_fa, pairs_fa, ct, uniq4)
        run_knots(card, dev, tmp, args.seed)
        run_slice4c(card, dev, tmp, args.seed)
        run_qf(card, dev, tmp, pairs_fa, args.seed)
        check_shard_kernels(args.seed, dev, reads_fa, ct, rec, star)
        slice7a = run_sharded(card, dev, tmp, reads_fa, ct)
        check_binshard_kernels(args.seed, dev, reads_fa, ct, rec)
        slice15 = run_binshard(card, dev, tmp, reads_fa, ct)
    # each kernel's launches by the path that runs it: slice 1's by the
    # main path (phase 4), slice 2's by the phase-5 path, K8 and K9 by the
    # murmur path (phase 6), which also gives K5's murmur launches, K10 by
    # the partitioning path (phase 7), K11 and K5c by the slice-3b path
    # (phase 8), K12 by the slice-10 path (phase 9); K13 and K14 by the
    # main path's saves
    launches.update({k: slice2[k] for k in SOURCES
                     if k not in MAIN_PATH and k in slice2})
    launches.update({k: murmur[k] for k in ("murmur_hashes", "hll_update")})
    launches["cc_rounds"] = partition["cc_rounds"]
    launches.update({k: small[k] for k in ("cyclic_hashes",
                                           "row_counts_cyclic")})
    launches["band_mask_weights"] = slice10["band_mask_weights"]
    # slice 7a's by the sharded path (phase 13 (b), (c) for K10's split);
    # K17 is two entry points, a launch each
    launches.update({k: slice7a[k] for k in (
        "band_route", "combine_lanes", "sketch_get_tables", "cc_relax",
        "cc_jump")})
    launches["claim_news"] = slice7a["claim_scatter"] + \
        slice7a["claim_count"]
    # slice 15's by the bin-sharded path (phase 14 (b) and (d))
    launches.update({k: slice15[k] for k in ("owned_claims", "owned_add",
                                             "owned_get")})
    rec["row_counts"]["murmur_launches"] = murmur["row_counts_murmur"]

    from khmer_tpu_torch.kernels import (CC_BLOCK, CC_KERNELS_PER_ROUND,
                                         KERNELS_PER_CALL)

    # launches counts kernels launched; ms is per wrapper call, which
    # launches kernels_per_call kernels (for K10, a call of CC_BLOCK
    # rounds, as connected_components makes it)
    kernels_line = []
    for name, (source, replaces) in SOURCES.items():
        kernels_line.append(dict(name=name, route="cuda", source=source,
                                 replaces=replaces,
                                 launches=launches[name],
                                 kernels_per_call=KERNELS_PER_CALL.get(
                                     name, 1)
                                 if name != "cc_rounds" else
                                 CC_KERNELS_PER_ROUND * CC_BLOCK,
                                 **rec[name]))
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
