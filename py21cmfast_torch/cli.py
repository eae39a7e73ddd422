"""Command-line interface: `21cmfast-torch` and `python -m py21cmfast_torch`.

Equivalent of reference cli.py:1-1030 (cyclopts app `21cmfast`), built on
argparse as py21cmfast_tpu/cli.py is, with its subcommands, options and
output lines: template avail/show/create, run params/ics/coeval/lightcone/
global, predict, dev feature.  Every command that computes takes
`--device {cuda,cpu}` (default cuda, the entry points' `device=`); without a
card, `--device cuda` raises rather than falling back.  A command that will
write HDF5 files (`run ics`, `run coeval --cache-dir`, `run lightcone --out`)
checks for h5py before it computes anything.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _build_inputs(args):
    from ._templates import create_params_from_template
    from .inputs import InputParameters

    overrides = {}
    for kv in args.param or []:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if args.template:
        return create_params_from_template(
            args.template, random_seed=args.seed, **overrides
        )
    return InputParameters(random_seed=args.seed).evolve_input_structs(**overrides)


def cmd_template_avail(args):
    from ._templates import list_templates

    for t in list_templates():
        aliases = f" (aliases: {', '.join(t['aliases'])})" if t.get("aliases") else ""
        print(f"{t['name']:18s} {t['description']}{aliases}")


def cmd_template_show(args):
    from .input_serialization import serialize_inputs

    inputs = _build_inputs(args)
    print(json.dumps(serialize_inputs(inputs), indent=2))


def cmd_template_create(args):
    """Write a new run-template TOML from a base template plus overrides
    (reference cli.py `template create`, :227-420)."""
    from .input_serialization import write_inputs_to_toml

    inputs = _build_inputs(args)
    write_inputs_to_toml(inputs, args.out)
    print(f"wrote {args.out}")


def cmd_run_params(args):
    """Show the resolved simulation parameters, grouped by struct
    (reference cli.py `run params`, :481-500)."""
    from .input_serialization import serialize_inputs

    inputs = _build_inputs(args)
    d = serialize_inputs(inputs)
    for group, fields in d.items():
        if not isinstance(fields, dict):
            print(f"{group} = {fields}")
            continue
        print(f"[{group}]")
        for k, v in sorted(fields.items()):
            print(f"  {k} = {v}")
        print()


def cmd_run_ics(args):
    """Compute initial conditions only, writing to the cache
    (reference cli.py `run ics`, :502-547)."""
    from .io.caching import OutputCache
    from .io.h5 import require_h5py
    from .models.ics import compute_initial_conditions
    from .outputs import InitialConditions

    require_h5py()
    inputs = _build_inputs(args)
    cache = OutputCache(args.cache_dir)
    if cache.exists(InitialConditions, inputs):
        if args.regenerate:
            print("initial conditions already exist; regenerating as requested")
        else:
            print(
                "initial conditions already exist in "
                f"{args.cache_dir}; skipping computation (--regenerate to override)"
            )
            return
    ics = compute_initial_conditions(inputs, device=args.device)
    cache.write(ics, inputs)
    print(f"saved initial conditions to {args.cache_dir}")


def cmd_run_coeval(args):
    from .drivers.coeval import run_coeval
    from .io.caching import OutputCache
    from .io.h5 import require_h5py

    if args.cache_dir:
        require_h5py()
    inputs = _build_inputs(args)
    cache = OutputCache(args.cache_dir) if args.cache_dir else None
    coevals = run_coeval(inputs, [float(z) for z in args.redshift], device=args.device)
    if not isinstance(coevals, list):
        coevals = [coevals]
    for cv in coevals:
        xh = float(np.mean(cv.neutral_fraction.cpu().numpy()))
        tb = float(np.mean(cv.brightness_temp.cpu().numpy()))
        print(f"z={cv.redshift:7.3f}  <xH>={xh:.4f}  <Tb>={tb:8.3f} mK")
        if cache is not None:
            cache.write(cv.ionized_box, inputs)
            cache.write(cv.brightness_temperature, inputs)
    return coevals


def cmd_run_lightcone(args):
    from .drivers.lightcone import run_lightcone
    from .io.h5 import require_h5py

    if args.out:
        require_h5py()
    inputs = _build_inputs(args).with_logspaced_redshifts(args.min_z, args.max_z)
    lc = run_lightcone(inputs, device=args.device)
    bt = lc.brightness_temp
    print(
        f"lightcone: shape={tuple(bt.shape)}, Tb range [{bt.min().item():.2f}, "
        f"{bt.max().item():.2f}] mK"
    )
    if args.out:
        import h5py

        with h5py.File(args.out, "w") as f:
            for q, arr in lc.to_numpy().items():
                f.create_dataset(q, data=arr, compression="gzip")
            f.create_dataset("lc_distances", data=lc.lc_distances)
            f.create_dataset("node_redshifts", data=lc.node_redshifts)
            for q, arr in lc.global_quantities.items():
                f.create_dataset(f"global/{q}", data=arr)
        print(f"wrote {args.out}")
    return lc


def cmd_run_global(args):
    from .drivers.global_evolution import run_global_evolution

    inputs = _build_inputs(args)
    ge = run_global_evolution(inputs, min_redshift=args.min_z, max_redshift=args.max_z,
                              device=args.device)
    for i, z in enumerate(ge.redshifts):
        line = f"z={z:7.3f}  <xH>={ge.neutral_fraction[i]:.4f}  <Tb>={ge.brightness_temp[i]:8.3f} mK"
        if ge.spin_temperature is not None:
            line += f"  Ts={ge.spin_temperature[i]:8.2f} K  Tk={ge.kinetic_temperature[i]:8.2f} K"
        print(line)
    return ge


def _host_lightcone(lc):
    """The LightCone with its cones copied to the host as numpy arrays."""
    import dataclasses

    return dataclasses.replace(lc, lightcones=lc.to_numpy())


def cmd_dev_feature(args):
    """Compare a default lightcone against one with a new feature enabled
    (reference cli.py `dev feature`, :723-920): slice plots, global-history
    differences, and chunked power-spectrum ratio plots, saved with the
    prefix `pr_feature` in --outdir."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from . import plotting
    from .drivers.lightcone import run_lightcone
    from .ops.ps import reference_binned_power

    base_args = argparse.Namespace(**vars(args))
    base_args.param = []
    inputs_default = _build_inputs(base_args).with_logspaced_redshifts(
        args.min_z - 0.1, args.max_z
    )
    inputs_new = _build_inputs(args).with_logspaced_redshifts(
        args.min_z - 0.1, args.max_z
    )
    if not args.param:
        print("warning: no --param overrides; 'new' run equals the default")

    print("running default lightcone...")
    lc_default = _host_lightcone(run_lightcone(inputs_default, device=args.device))
    print("running lightcone with new feature...")
    lc_new = _host_lightcone(run_lightcone(inputs_new, device=args.device))

    outdir = args.outdir

    # --- lightcone slices: default / new / difference ---
    fig, ax = plt.subplots(3, 1, sharex=True, sharey=True, figsize=(12, 7))
    plotting.lightcone_sliceplot(lc_default, ax=ax[0], fig=fig, vmin=-150, vmax=30)
    ax[0].set_title("Default")
    plotting.lightcone_sliceplot(lc_new, ax=ax[1], fig=fig, vmin=-150, vmax=30)
    ax[1].set_title("New")
    diff = lc_default.brightness_temp - lc_new.brightness_temp
    ax[2].imshow(diff[0].T if diff.ndim == 3 else diff.T, aspect="auto", cmap="bwr")
    ax[2].set_title("Difference")
    fig.savefig(f"{outdir}/pr_feature_lightcone_2d_brightness_temp.pdf")
    plt.close(fig)

    # --- global history + rms differences ---
    def rms(x, axis=None):
        return np.sqrt(np.mean(np.asarray(x, dtype=np.float64) ** 2, axis=axis))

    fig, ax = plt.subplots(4, 1, sharex=True, figsize=(8, 10),
                           gridspec_kw={"hspace": 0.05})
    zs_d, zs_n = lc_default.node_redshifts, lc_new.node_redshifts
    for lc, zs, lbl in ((lc_default, zs_d, "Default"), (lc_new, zs_n, "New")):
        ax[0].plot(zs, lc.global_quantities["neutral_fraction"], label=lbl)
        ax[1].plot(zs, lc.global_quantities["brightness_temp"], label=lbl)
    ax[0].set_ylabel(r"$x_{\rm HI}$")
    ax[0].legend()
    ax[1].set_ylabel("$T_b$ [mK]")
    lcz = lc_default.lc_redshifts
    rms_diff = rms(lc_default.brightness_temp, axis=(0, 1)) - rms(
        lc_new.brightness_temp, axis=(0, 1)
    )
    ax[2].plot(lcz, rms_diff, label="RMS")
    ax[2].plot(zs_d, np.asarray(lc_default.global_quantities["neutral_fraction"])
               - np.asarray(lc_new.global_quantities["neutral_fraction"]), label="$x_{HI}$")
    ax[2].plot(zs_d, np.asarray(lc_default.global_quantities["brightness_temp"])
               - np.asarray(lc_new.global_quantities["brightness_temp"]), label="$T_b$")
    ax[2].legend()
    ax[2].set_ylabel("Differences")
    diff_rms = rms(lc_default.brightness_temp - lc_new.brightness_temp, axis=(0, 1))
    ax[3].plot(lcz, diff_rms)
    ax[3].set_ylabel("RMS of Diff.")
    ax[3].set_xlabel("z")
    fig.savefig(f"{outdir}/pr_feature_history.pdf")
    plt.close(fig)

    # --- chunked power spectra: default vs new, with ratio ---
    print("plotting power spectra history...")
    n_chunks = args.n_ps_chunks
    bt_d = np.asarray(lc_default.brightness_temp)
    bt_n = np.asarray(lc_new.brightness_temp)
    n_sl = min(bt_d.shape[-1], bt_n.shape[-1])
    chunk = max(n_sl // n_chunks, 1)
    cell = inputs_default.simulation_options.box_len / inputs_default.simulation_options.HII_DIM
    fig, ax = plt.subplots(2, n_chunks, figsize=(4 * n_chunks, 6), sharex=True,
                           squeeze=False, gridspec_kw={"hspace": 0.05})
    for i in range(n_chunks):
        sl = slice(i * chunk, min((i + 1) * chunk, n_sl))
        box_lens = (
            inputs_default.simulation_options.box_len,
            inputs_default.simulation_options.box_len,
            cell * (sl.stop - sl.start),
        )
        k_d, p_d, _ = reference_binned_power(bt_d[..., sl], box_lens)
        k_n, p_n, _ = reference_binned_power(bt_n[..., sl], box_lens)
        zmid = float(lcz[(sl.start + sl.stop) // 2])
        ok = (p_d > 0) & (p_n > 0)
        ax[0][i].loglog(k_d[ok], p_d[ok], label="Default")
        ax[0][i].loglog(k_n[ok], p_n[ok], label="New")
        ax[0][i].set_title(f"z ~ {zmid:.1f}")
        ax[1][i].semilogx(k_d[ok], p_n[ok] / p_d[ok])
        ax[1][i].axhline(1.0, color="k", lw=0.5)
        ax[1][i].set_xlabel("k [1/Mpc]")
    ax[0][0].set_ylabel("P(k)")
    ax[0][0].legend()
    ax[1][0].set_ylabel("New / Default")
    fig.savefig(f"{outdir}/pr_feature_power_history.pdf")
    plt.close(fig)
    print(f"wrote pr_feature_*.pdf to {outdir}")


def cmd_predict(args):
    inputs = _build_inputs(args)
    so = inputs.simulation_options
    f32 = 4
    hires = int(np.prod(so.hires_shape)) * f32
    lowres = int(np.prod(so.lowres_shape)) * f32
    n_ic = 2 + 6 if inputs.matter_options.PERTURB_ALGORITHM == "2LPT" else 2 + 3
    per_snap = 6 if inputs.astro_options.USE_TS_FLUCT else 4
    print(f"hires grid:  {hires/2**30:.2f} GiB each ({so.hires_shape})")
    print(f"lowres grid: {lowres/2**30:.3f} GiB each ({so.lowres_shape})")
    print(f"ICs total:   {(2*hires + (n_ic-1)*lowres)/2**30:.2f} GiB")
    print(f"per-snapshot boxes: ~{per_snap*lowres/2**30:.2f} GiB")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="21cmfast-torch", description="21cmFAST simulator on PyTorch and CUDA"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--template", default=None, help="template name (see 'template avail')")
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument(
            "--param", "-p", action="append",
            help="parameter override KEY=VALUE (repeatable)",
        )

    def computes(sp):
        common(sp)
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the fields are computed (default: cuda)")

    t = sub.add_parser("template", help="inspect parameter templates")
    tsub = t.add_subparsers(dest="tcmd", required=True)
    tav = tsub.add_parser("avail", help="list templates")
    tav.set_defaults(func=cmd_template_avail)
    tsh = tsub.add_parser("show", help="show resolved parameters")
    common(tsh)
    tsh.set_defaults(func=cmd_template_show)
    tcr = tsub.add_parser(
        "create", help="write a new template TOML from a base + overrides"
    )
    common(tcr)
    tcr.add_argument("out", help="output TOML path")
    tcr.set_defaults(func=cmd_template_create)

    r = sub.add_parser("run", help="run simulations")
    rsub = r.add_subparsers(dest="rcmd", required=True)

    rp = rsub.add_parser("params", help="show resolved simulation parameters")
    common(rp)
    rp.set_defaults(func=cmd_run_params)

    ri = rsub.add_parser("ics", help="initial conditions only, written to cache")
    computes(ri)
    ri.add_argument("--cache-dir", default="_cache")
    ri.add_argument("--regenerate", action="store_true",
                    help="recompute even if cached ICs exist")
    ri.set_defaults(func=cmd_run_ics)

    rc = rsub.add_parser("coeval", help="coeval cube(s)")
    computes(rc)
    rc.add_argument("--redshift", "-z", nargs="+", required=True, type=float)
    rc.add_argument("--cache-dir", default=None)
    rc.set_defaults(func=cmd_run_coeval)

    rl = rsub.add_parser("lightcone", help="full lightcone")
    computes(rl)
    rl.add_argument("--min-z", type=float, default=6.0)
    rl.add_argument("--max-z", type=float, default=30.0)
    rl.add_argument("--out", default=None, help="output HDF5 path")
    rl.set_defaults(func=cmd_run_lightcone)

    rg = rsub.add_parser("global", help="global (0-D) signal")
    computes(rg)
    rg.add_argument("--min-z", type=float, default=5.5)
    rg.add_argument("--max-z", type=float, default=None)
    rg.set_defaults(func=cmd_run_global)

    pr = sub.add_parser("predict", help="memory estimates")
    common(pr)
    pr.set_defaults(func=cmd_predict)

    d = sub.add_parser("dev", help="developer utilities")
    dsub = d.add_subparsers(dest="dcmd", required=True)
    df = dsub.add_parser(
        "feature",
        help="compare a default lightcone against one with --param overrides",
    )
    computes(df)
    df.add_argument("--min-z", type=float, default=6.0)
    df.add_argument("--max-z", type=float, default=30.0)
    df.add_argument("--outdir", default=".")
    df.add_argument("--n-ps-chunks", type=int, default=4)
    df.set_defaults(func=cmd_dev_feature)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
