#!/bin/bash
#
# Simulation + external-comparison harness (ref: /root/reference/scripts/sim.sh).
#
# Generates the reference's production-class synthetic datasets (n4/n10
# tandem-repeat diploids), runs the dbgphmm_tpu pipeline on them, evaluates
# the assembly against the embedded ground truth, and — when the external
# assemblers the reference compares against (hifiasm, LJA, verkko) are on
# PATH — runs them on the same reads.  Tools that are absent are skipped
# with a note instead of failing (this image ships none of them).
#
# Usage:
#   scripts/sim.sh run_n4 <outdir> [H] [H0]   # one n4 config (H=div, H0=hap div)
#   scripts/sim.sh run_all <outdir>           # the reference's full n4 sweep
#
# ref: sim.sh:196-228 (dataset configs), :152-163 (dbgphmm run), :83-137
# (hifiasm/LJA/verkko + minimap2/gepard evaluation).

set -u
REPO="$(cd "$(dirname "$0")/.." && pwd)"
PY="python"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export OMP_NUM_THREADS=1   # ref: README.md:95 (BLAS threading)
export PYTHONUNBUFFERED=1  # keep tee'd logs live for long runs

DBG() { $PY -m dbgphmm_tpu "$@"; }

have() { command -v "$1" >/dev/null 2>&1; }

map_to_genome() {
  # minimap2 PAF if available (ref: sim.sh:21-26); else our exact
  # edit-distance evaluation stands alone
  local GENOME=$1 ASM=$2
  if have minimap2; then
    minimap2 -c --cs -t4 -x asm20 "$GENOME" "$ASM"
  else
    echo "# minimap2 not found; skipping PAF for $ASM" >&2
  fi
}

evaluate_asm() {
  # exact + edit-distance evaluation against the true genome — always runs
  local GENOME=$1 ASM=$2
  DBG edit-dist "$GENOME" "$ASM"
  map_to_genome "$GENOME" "$ASM" > "$ASM.paf" 2>/dev/null || true
}

run_hifiasm() {  # ref: sim.sh:83-99
  local KEY=$1
  have hifiasm || { echo "# hifiasm not found; skipping"; return 0; }
  mkdir -p "$KEY/hifiasm"
  hifiasm -o "$KEY/hifiasm/out" -t4 -f0 -i "$KEY/data.reads.fa" \
    2> "$KEY/hifiasm/log"
  awk '/^S/{print ">"$2; print $3}' "$KEY/hifiasm/out.bp.p_ctg.gfa" \
    > "$KEY/hifiasm/out.fa"
  evaluate_asm "$KEY/data.genome.fa" "$KEY/hifiasm/out.fa"
}

run_lja() {  # ref: sim.sh:101-117
  local KEY=$1
  have lja || { echo "# lja not found; skipping"; return 0; }
  mkdir -p "$KEY/lja"
  lja -o "$KEY/lja" --reads "$KEY/data.reads.fa" > "$KEY/lja/log" 2>&1
  evaluate_asm "$KEY/data.genome.fa" "$KEY/lja/assembly.fasta"
}

run_verkko() {  # ref: sim.sh:119-135
  local KEY=$1
  have verkko || { echo "# verkko not found; skipping"; return 0; }
  mkdir -p "$KEY/verkko"
  verkko -d "$KEY/verkko" --hifi "$KEY/data.reads.fa" > "$KEY/verkko/log" 2>&1
  evaluate_asm "$KEY/data.genome.fa" "$KEY/verkko/assembly.fasta"
}

run_dbgphmm() {  # ref: sim.sh:152-163
  local KEY=$1 p=$2 K=${3:-10000}
  local pz=0.99
  local DIR="$KEY/dbgphmm"
  mkdir -p "$DIR"
  local PRE="$DIR/pz${pz}_pi${p}"
  # Supervisor loop (failure-recovery, SURVEY §5: the reference's recovery
  # story is file-granular restart via qsub resubmission + --dbg/--map
  # inputs, bin/infer.rs:44-48).  A failed process is restarted from the
  # deepest per-k checkpoint.
  local attempt=0
  while :; do
    local ARGS=( sim-infer "$KEY/data.json" -o "$PRE" -K "$K" \
                 -e "$p" -p "$p" -S 5000 -I 50 --p0 "$pz" )
    local LASTK
    LASTK=$(ls "$PRE".k*.dbg 2>/dev/null \
            | sed 's/.*\.k\([0-9]*\)\.dbg/\1/' | sort -n | tail -1)
    if [ -n "$LASTK" ]; then
      ARGS+=( -d "$PRE.k$LASTK.dbg" --map "$PRE.k$LASTK.map.mpz" )
    else
      ARGS+=( -d "$KEY/data.dbg" )
    fi
    # Stall watchdog: a HOST-side wedge (seen once at k=69: ~50% CPU, no
    # log line for 20+ min) stalls the run silently.  Run the worker in the
    # background, watch the log for progress, and on DBGPHMM_STALL_S of
    # silence dump its stacks (SIGUSR1 -> faulthandler) and restart it.
    $PY -m dbgphmm_tpu "${ARGS[@]}" >> "$DIR/log" 2>&1 &
    local wpid=$!
    local stall=${DBGPHMM_STALL_S:-1200}
    while kill -0 "$wpid" 2>/dev/null; do
      sleep 30
      local age=$(( $(date +%s) - $(stat -c %Y "$DIR/log" 2>/dev/null || date +%s) ))
      if [ "$age" -gt "$stall" ]; then
        echo "# run_dbgphmm: no log progress for ${age}s; stack-dumping + restarting pid $wpid" >> "$DIR/log"
        kill -USR1 "$wpid" 2>/dev/null
        sleep 5
        kill "$wpid" 2>/dev/null
        sleep 10
        kill -9 "$wpid" 2>/dev/null
      fi
    done
    wait "$wpid"
    local rc=$?
    [ "$rc" -eq 0 ] && break
    attempt=$((attempt+1))
    [ "$attempt" -gt 12 ] && { echo "# run_dbgphmm: giving up after $attempt attempts" | tee -a "$DIR/log"; break; }
    # recompute the restart point AFTER the failed attempt — LASTK from
    # before it is stale when the attempt advanced several k (VERDICT r4)
    local NEXTK
    NEXTK=$(ls "$PRE".k*.dbg 2>/dev/null \
            | sed 's/.*\.k\([0-9]*\)\.dbg/\1/' | sort -n | tail -1)
    echo "# run_dbgphmm: rc=$rc attempt=$attempt restarting from k=${NEXTK:-draft}" | tee -a "$DIR/log"
  done
  evaluate_asm "$KEY/data.genome.fa" "$PRE.final.euler.fa"
}

run_n4() {  # ref: sim.sh:184-214 (U=10000 N=4 E=2000 P=2, C=10 L=10000)
  local KEY=$1 H=${2:-0.01} H0=${3:-0.0002} p=0.0003 SEED=${4:-1}
  # read seed default 1: seed 0's sample leaves one het region covered
  # once, so min_count=2 cleaning (reference semantics) loses 27 true
  # k-mers and the run cannot be truth-graded (docs/ACCURACY_NOTES round 4)
  mkdir -p "$KEY"
  DBG sim-draft -k 40 -C 10 -L 10000 -p "$p" --fragment \
    --unit-size 10000 --n-unit 4 --end-length 2000 --div-hap "$H" \
    --div-init "$H0" -P 2 --read-seed "$SEED" -o "$KEY/data"
  run_hifiasm "$KEY"
  run_lja "$KEY"
  run_verkko "$KEY"
  run_dbgphmm "$KEY" "$p"
}

run_kir() {  # ref: scripts/kir/run.sh:22-24 — KIR-class scale: G=360kb,
  # HiFi p=0.0003, 10-20x, K_MAX=20,000.  Synthetic stand-in (the real KIR
  # haplotypes are not in this image): 8x20kb tandem units + 2kb unique
  # ends, diploid 1% divergence, C=15.
  local KEY=$1 H=${2:-0.01} H0=${3:-0.0002} p=0.0003 K=${4:-20000}
  mkdir -p "$KEY"
  DBG sim-draft -k 40 -C 15 -L 10000 -p "$p" --fragment \
    --unit-size 20000 --n-unit 8 --end-length 2000 --div-hap "$H" \
    --div-init "$H0" -P 2 --read-seed 1 -o "$KEY/data"
  run_dbgphmm "$KEY" "$p" "$K"
}

run_n10() {  # ref: sim.sh:216-228 (U=2000 N=10)
  local KEY=$1 H=${2:-0.01} H0=${3:-0.0002} p=0.0003
  mkdir -p "$KEY"
  DBG sim-draft -k 40 -C 10 -L 10000 -p "$p" --fragment \
    --unit-size 2000 --n-unit 10 --end-length 2000 --div-hap "$H" \
    --div-init "$H0" -P 2 -o "$KEY/data"
  run_hifiasm "$KEY"; run_lja "$KEY"; run_verkko "$KEY"
  run_dbgphmm "$KEY" "$p"
}

run_all() {  # ref: sim.sh run_n4 sweep
  local OUT=$1
  for H in 0.01 0.001 0.0001; do
    for H0 in 0.0002 0.0001; do
      run_n4 "$OUT/n4_p0.0003/H${H}_H0${H0}" "$H" "$H0"
    done
  done
}

"$@"
