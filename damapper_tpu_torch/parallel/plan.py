"""Execution-plan generator: HPC.damapper equivalent for CUDA hosts.

The reference emits a shell script of embarrassingly-parallel damapper
commands over read-block ranges plus an LAcheck house-keeping block
(HPC.damapper.c:48-510, README.md:71-104), with restart-from-last-block
resume semantics (block fblock-1's .las must exist, fblock's must not,
HPC.damapper.c:289-357).

`generate_plan` reproduces that contract for this framework: each job maps -B
read blocks on one host (each host maps on its own CUDA card).  Output is
either the classic shell script (`fmt="sh"`) or a machine-readable JSON
schedule (`fmt="json"`) binding jobs to host ranks, which
`parallel.launch` runs.  Every line names this package's CLI (`CLI`).
"""

from __future__ import annotations

import json
import os
import sys

from ..io import db as dbio

CLI = "python -m damapper_tpu_torch.cli"


def _roots(path: str):
    pwd, root, isdam = dbio._split_db_path(path)
    usepath = pwd not in (".", "")
    return pwd, root, isdam, usepath


# Cluster submission decorations (reference HPC.damapper.c:22-46, where
# they are compile-time #ifdef LSF / #ifdef SLURM; here a runtime option).
# %d fields: LSF jobid; SLURM threads, mem-per-cpu (MB), jobid.
HPC_ALIGN_LSF = ("bsub -q medium -n 4 -o DAMAPPER.out -e DAMAPPER.err "
                 "-R span[hosts=1] -J map#%d")
HPC_ALIGN_SLURM = ("srun -p batch -n 1 -c %d --mem_per_cpu=%d "
                   "-o DALIGNER.out -e DALIGNER.err -J map#%d")


def _submit_prefix(submit: str | None, jobid: int, nthreads: int,
                   mem_gb: int | None) -> str:
    if submit == "lsf":
        return HPC_ALIGN_LSF % jobid + ' "'
    if submit == "slurm":
        # the reference rounds NTHREADS down to a power of two before it
        # reaches the -c / --mem_per_cpu fields (HPC.damapper.c:210-212)
        j = 1
        while 2 * j <= max(nthreads, 1):
            j *= 2
        nthreads = j
        mem = (mem_gb * 1024 if mem_gb is not None and mem_gb >= 0
               else 16 * 1024) // nthreads
        return HPC_ALIGN_SLURM % (nthreads, mem, jobid) + ' "'
    return ""


def generate_plan(ref_path: str, reads_path: str, *, bunit: int = 4,
                  first_block: int | None = None,
                  last_block: int | None = None,
                  damapper_cmd: str = f"{CLI} damapper",
                  opts: str = "", nhosts: int | None = None,
                  fmt: str = "sh", check_resume: bool = True,
                  oname: str | None = None,
                  submit: str | None = None) -> str:
    pwd1, root1, isdam1, usepath1 = _roots(ref_path)
    pwd2, root2, isdam2, usepath2 = _roots(reads_path)
    if root1 == root2 and pwd1 == pwd2:
        raise ValueError("Comparing a database against itself; "
                         "use an overlapper plan")

    stub2 = dbio.read_stub(os.path.join(
        pwd2, root2 + (".dam" if isdam2 else ".db")))
    useblock2 = stub2.nblocks > 1
    nblocks2 = max(stub2.nblocks, 1)

    fblock = 1 if first_block is None else first_block
    lblock = nblocks2 if last_block is None else last_block
    if first_block is not None or last_block is not None:
        useblock2 = True
    if fblock < 1 or lblock > nblocks2 or fblock > lblock:
        raise ValueError(f"range {fblock}-{lblock} is empty or out of bounds")

    src2 = os.path.join(pwd2, root2) if usepath2 else root2
    src1 = os.path.join(pwd1, root1) if usepath1 else root1

    # resume contract (HPC.damapper.c:329-354)
    if check_resume:
        if fblock > 1 and not os.path.exists(
                f"{src2}.{fblock - 1}.{root1}.las"):
            raise FileNotFoundError(
                f"File {src2}.{fblock - 1}.{root1}.las should already be "
                f"present!")
        probe = (f"{src2}.{fblock}.{root1}.las" if useblock2
                 else f"{src2}.{root1}.las")
        if os.path.exists(probe):
            raise FileExistsError(f"File {probe} should not yet exist!")

    bunit = max(bunit, 1)
    bits = (lblock - fblock) // bunit + 1
    jobs = []
    low = fblock
    for j in range(1, bits + 1):
        hgh = fblock + ((lblock - fblock + 1) * j) // bits
        blocks = list(range(low, hgh))
        args = [src1] + [f"{src2}.{k}" if useblock2 else src2
                         for k in blocks]
        jobs.append({"blocks": blocks, "args": args})
        low = hgh

    if fmt == "json":
        n = nhosts or len(jobs)
        plan = {
            "reference": src1,
            "reads": src2,
            "jobs": [
                {"host": i % n, "cmd": f"{damapper_cmd} {opts} "
                                       + " ".join(j["args"]),
                 "blocks": j["blocks"]}
                for i, j in enumerate(jobs)
            ],
            "check": [f"{CLI} lacheck "
                      f"{src2}.@{fblock}-{lblock}.{root1}.las"
                      if useblock2 else
                      f"{CLI} lacheck {src2}.{root1}.las"],
            "merge": (f"{CLI} lamerge "
                      f"{src2}.{root1}.las "
                      f"{src2}.@{fblock}-{lblock}.{root1}.las"
                      if useblock2 else None),
            "resume": {"contract": "block N-1 .las present, block N absent",
                       "first_block": fblock, "last_block": lblock},
        }
        return json.dumps(plan, indent=2)

    # -T / -M from opts drive the SLURM resource fields, as in the
    # reference where NTHREADS/MINT feed HPC_ALIGN (HPC.damapper.c:389)
    nthreads, mem_gb = 4, None
    for tok in opts.split():
        if tok.startswith("-T"):
            nthreads = int(tok[2:])
        elif tok.startswith("-M"):
            mem_gb = int(tok[2:])

    job_lines = [f"# Damapper jobs ({len(jobs)})"]
    for jobid, j in enumerate(jobs, start=1):
        pre = _submit_prefix(submit, jobid, nthreads, mem_gb)
        cmd = (f"{damapper_cmd}{(' ' + opts) if opts else ''} "
               + " ".join(j["args"]))
        job_lines.append(pre + cmd + ('"' if pre else ""))
    check_lines = ["# Check all .las files (optional but recommended)"]
    zon = "-z" in opts.split()
    ckflags = "-v" + ("" if zon else "a") + "S"
    if useblock2:
        check_lines.append(f"{CLI} lacheck {ckflags} "
                           f"{src2}.@{fblock}-{lblock}.{root1}.las")
    else:
        check_lines.append(f"{CLI} lacheck {ckflags} "
                           f"{src2}.{root1}.las")

    if oname is not None:
        # -f<name> job bundles (HPC.damapper.c:135-140, 364-367, 448-452;
        # README.md:91-104): jobs to <name>.01.OVL, check block to
        # <name>.02.CHECK.OPT, nothing on stdout
        with open(f"{oname}.01.OVL", "w") as fh:
            fh.write("\n".join(job_lines) + "\n")
        with open(f"{oname}.02.CHECK.OPT", "w") as fh:
            fh.write("\n".join(check_lines) + "\n")
        return ""
    return "\n".join(job_lines + check_lines) + "\n"


def main_plan(argv: list[str]) -> int:
    """CLI: plan [-vpzCN] [-B<int>] [-f<json|sh|name>] [--lsf|--slurm]
    [-k..-t..-e..-s..-n..-M..-T..] <ref> <reads> [first[-last]]

    -fjson / -fsh pick the stdout format; any other -f<name> writes the
    reference's job bundles <name>.01.OVL + <name>.02.CHECK.OPT
    (HPC.damapper.c:135-140).  --lsf/--slurm prefix each job with the
    cluster submission decoration (HPC.damapper.c:22-46)."""
    opts = []
    bunit = 4
    fmt = "sh"
    oname = None
    submit = None
    args = []
    for a in argv:
        if a.startswith("-B"):
            bunit = int(a[2:])
        elif a == "--lsf":
            submit = "lsf"
        elif a == "--slurm":
            submit = "slurm"
        elif a.startswith("-f"):
            if a[2:] in ("json", "sh", ""):
                fmt = a[2:] or "sh"
            else:
                oname = a[2:]
        elif a.startswith("-"):
            opts.append(a)
        else:
            args.append(a)
    if len(args) < 2:
        print(main_plan.__doc__, file=sys.stderr)
        return 1
    first = last = None
    if len(args) > 2:
        rng = args[2].split("-")
        first = int(rng[0])
        last = int(rng[1]) if len(rng) > 1 else first
    print(generate_plan(args[0], args[1], bunit=bunit,
                        first_block=first, last_block=last,
                        opts=" ".join(opts), fmt=fmt, oname=oname,
                        submit=submit), end="")
    return 0
