#!/usr/bin/env python
"""Product-session orchestration on the PyTorch/CUDA port: the reference's
`scripts/` layer as one CLI. The counterpart of `apps/mapping_session.py`,
with the same subcommands and session layout; `start` launches the port's
apps (`run_mapping_offline_torch.py`, `run_slam_offline_torch.py`) with
`--device` passed through, and `pub-occ-map` reads the PGM with the port's
`maps.occupancy`.

Behavioral parity targets (all under /root/reference/scripts/):
  - `mapping.sh:1-69`       -> `start`: timestamped map session directory
    (`<root>/system/maps/<name>-<YYYYmmdd-HHMMSS>/details/frames`), the
    `default` symlink (backing up a non-symlink `default`), optional
    activation of the new map via the `<root>/system/map` symlink
    (validate=y/n), and mode dispatch (fast -> LIO + occupancy pipeline,
    indoor/outdoor -> LIO-SAM pipeline; `pointcloud_mapping.sh` role).
  - `save_map.sh`           -> `save-map`: publish the session's occupancy
    grid (PGM/YAML) into `<root>/system/map/<name>.pgm/.yaml` (the
    map_server `map_saver` role).
  - `set_floor_label.sh`    -> `set-floor-label`: the /mapping/floor_label
    std_msgs/Int8 channel becomes a per-session current-label file plus an
    append-only history; `construct_full_map --floor_labels` consumes the
    per-keyframe expansion.
  - `register_conf.sh:1-30` -> `register-conf`: copy the per-lidar YAML for
    each package into `<root>/system/conf/slam/<pkg>/params.yaml` (chosen by
    `<root>/system/conf/lidar_type`, idempotent — existing files win).
  - `*_stop.sh`             -> `stop`: terminate the processes `start --run`
    recorded in `<session>/details/pids` (recorded PIDs only, never
    pattern-matched).
  - `mapping_GUI.py`        -> `interactive`: a minimal terminal menu that
    drives the same commands (the Tk GUI is a thin wrapper over mapping.sh).

The reference hardcodes `/home/ysc/jy_cog`; here `--root` (or
POINTCLOUD_SLAM_ROOT) picks the deployment root, defaulting to `~/jy_cog`.
"""

import argparse
import datetime
import os
import shutil
import signal
import subprocess
import sys

APP_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(APP_DIR)
sys.path.insert(0, REPO_DIR)

# package -> local config directory (register_conf.sh package_list_type)
_CONF_ROOT = os.environ.get("POINTCLOUD_SLAM_CONFIGS", os.path.join(REPO_DIR, "configs"))
CONF_PACKAGES = {
    "jueying_lio": os.path.join(_CONF_ROOT, "lio"),
    "jueying_slam": os.path.join(_CONF_ROOT, "slam"),
}


def _maps_root(root):
    return os.path.join(root, "system", "maps")


def _now_stamp():
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def cmd_start(args):
    """mapping.sh: create the session dir, manage default/map symlinks,
    compose (and optionally launch) the mapping pipeline."""
    maps_path = _maps_root(args.root)
    folder = f"{args.map_name}-{_now_stamp()}"
    session = os.path.join(maps_path, folder)
    os.makedirs(os.path.join(session, "details", "frames"), exist_ok=True)

    # `default` symlink handling (mapping.sh:28-44): a symlink is replaced,
    # a real directory is backed up as default-<stamp>
    default = os.path.join(maps_path, "default")
    if os.path.islink(default):
        os.unlink(default)
    elif os.path.isdir(default):
        shutil.move(default, f"{default}-{_now_stamp()}")
    os.symlink(session, default)

    # activation (validate=y/n, mapping.sh:47-57): `<root>/system/map` points
    # at the map the rest of the system (localization, nav) uses
    if args.activate == "y":
        active = os.path.join(args.root, "system", "map")
        if os.path.islink(active) or os.path.isfile(active):
            os.unlink(active)
        elif os.path.isdir(active):
            # a REAL directory here is save-map's published PGM/YAML store —
            # back it up like the non-symlink `default`, never delete it
            shutil.move(active, f"{active}-{_now_stamp()}")
        os.symlink(session, active)
    elif args.activate != "n":
        print("[Warn] --activate takes y/n", file=sys.stderr)

    # mode dispatch (mapping.sh:60-69 + pointcloud_mapping.sh): `fast` runs
    # the LIO pipeline with the online occupancy mapper beside it;
    # indoor/outdoor run the LIO-SAM pipeline (feature + pose-graph backend)
    py = sys.executable
    out_map = os.path.join(session, "jueying.pcd")
    common = ["--data_dir", args.data_dir] if args.data_dir else ["--synthetic", str(args.synthetic)]
    common += ["--device", getattr(args, "device", "cuda")]
    if args.mode == "fast":
        cmds = [
            [py, os.path.join(APP_DIR, "run_mapping_offline_torch.py"), *common,
             "--traj_log_file", os.path.join(session, "details", "traj.txt"),
             "--time_log_file", os.path.join(session, "details", "time.csv"),
             "--map_file", out_map],
        ]
    else:  # indoor / outdoor
        cmds = [
            [py, os.path.join(APP_DIR, "run_slam_offline_torch.py"), *common,
             "--out_dir", os.path.join(session, "details"), "--save_artifacts"],
        ]

    print(f"session: {session}")
    if args.run and getattr(args, "device", "cuda").startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
    if args.run:
        pids = []
        logf = open(os.path.join(session, "details", "mapping.log"), "ab")
        for cmd in cmds:
            p = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
            pids.append(p.pid)
        with open(os.path.join(session, "details", "pids"), "w") as f:
            f.write("\n".join(str(p) for p in pids) + "\n")
        print(f"launched pids: {pids}")
    else:
        for cmd in cmds:
            print("would run:", " ".join(cmd))
    return session


def _resolve_session(args):
    """Commands act on the `default` session unless --session is given."""
    if args.session:
        return args.session
    default = os.path.join(_maps_root(args.root), "default")
    if not os.path.isdir(default):
        raise SystemExit(f"no active session ({default} missing); run `start` first")
    return os.path.realpath(default)


def cmd_save_map(args):
    """save_map.sh: session occupancy grid -> <root>/system/map/<name>.pgm/.yaml."""
    session = _resolve_session(args)
    # newest PGM in the session (the occupancy pipeline's saveMap product)
    pgms = []
    for dirpath, _, files in os.walk(session):
        pgms += [os.path.join(dirpath, f) for f in files if f.endswith(".pgm")]
    if not pgms:
        raise SystemExit(f"no .pgm occupancy product found under {session}")
    src = max(pgms, key=os.path.getmtime)
    dst_dir = os.path.join(args.root, "system", "map")
    os.makedirs(dst_dir, exist_ok=True)
    for ext in (".pgm", ".yaml"):
        s = src[:-4] + ext
        if not os.path.exists(s):
            continue
        dst = os.path.join(dst_dir, args.name + ext)
        if os.path.exists(dst) and os.path.samefile(s, dst):
            # an activated session is itself <root>/system/map: the newest PGM
            # may be the published one, which is already in place
            continue
        if ext == ".yaml":
            # the session YAML's image: field points at the session-internal
            # PGM path; the published pair must reference its own file
            lines = [
                f"image: {args.name}.pgm" if ln.startswith("image:") else ln
                for ln in open(s).read().splitlines()
            ]
            with open(dst, "w") as f:
                f.write("\n".join(lines) + "\n")
        else:
            shutil.copyfile(s, dst)
    print(f"saved {os.path.join(dst_dir, args.name)}.pgm/.yaml")


def cmd_pub_occ_map(args):
    """pub_occ_map.sh: re-publish the session's occupancy product (the
    reference's `rosservice call .../publish_occupancy_map`): validate the
    newest PGM/YAML pair parses, then publish it to <root>/system/map."""
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    session = _resolve_session(args)
    pgms = []
    for dirpath, _, files in os.walk(session):
        pgms += [os.path.join(dirpath, f) for f in files if f.endswith(".pgm")]
    if not pgms:
        raise SystemExit(f"no .pgm occupancy product found under {session}")
    newest = max(pgms, key=os.path.getmtime)
    grid, meta = occ.load_pgm(newest[:-4])  # parse check before publication
    n_occ = int((grid == 100).sum())
    print(f"publishing {newest}: {grid.shape[0]}x{grid.shape[1]} cells, "
          f"{n_occ} occupied, resolution {meta.get('resolution')}")
    cmd_save_map(args)


def cmd_set_floor_label(args):
    """set_floor_label.sh: update the session's floor-label channel."""
    session = _resolve_session(args)
    details = os.path.join(session, "details")
    os.makedirs(details, exist_ok=True)
    with open(os.path.join(details, "floor_label"), "w") as f:
        f.write(f"{args.label}\n")
    with open(os.path.join(details, "floor_label_history.csv"), "a") as f:
        f.write(f"{datetime.datetime.now().isoformat()},{args.label}\n")
    print(f"floor label <- {args.label}")


def cmd_register_conf(args):
    """register_conf.sh: per-lidar YAML -> system conf registry (idempotent)."""
    conf_root = os.path.join(args.root, "system", "conf")
    lt_file = os.path.join(conf_root, "lidar_type")
    lidar_type = args.lidar_type
    if not lidar_type:
        lidar_type = "livox"
        if os.path.exists(lt_file):
            with open(lt_file) as f:
                for line in f:
                    if line.strip():
                        lidar_type = line.strip()
    print(f"lidar_type: {lidar_type}")
    for pkg, cfg_dir in CONF_PACKAGES.items():
        dst_dir = os.path.join(conf_root, "slam", pkg)
        dst = os.path.join(dst_dir, "params.yaml")
        if os.path.exists(dst):
            print(f"{pkg}: params.yaml already registered")
            continue
        if not os.path.isdir(cfg_dir):
            # pip installs ship the package without the repo's configs/ tree;
            # point POINTCLOUD_SLAM_CONFIGS at a checkout (or run from one)
            print(f"{pkg}: no shipped configs at {cfg_dir} "
                  "(set POINTCLOUD_SLAM_CONFIGS to a repo checkout)", file=sys.stderr)
            continue
        src = os.path.join(cfg_dir, f"{lidar_type}.yaml")
        if not os.path.exists(src):
            # fall back to the first shipped config for the package, like the
            # reference falls back to whatever share/ contains
            cands = sorted(f for f in os.listdir(cfg_dir) if f.endswith(".yaml"))
            if not cands:
                continue
            src = os.path.join(cfg_dir, cands[0])
        os.makedirs(dst_dir, exist_ok=True)
        shutil.copyfile(src, dst)
        print(f"{pkg}: registered {os.path.basename(src)} -> {dst}")


def cmd_stop(args):
    """*_stop.sh: terminate ONLY the PIDs `start --run` recorded."""
    session = _resolve_session(args)
    pidfile = os.path.join(session, "details", "pids")
    if not os.path.exists(pidfile):
        print("nothing recorded to stop")
        return
    with open(pidfile) as f:
        pids = [int(x) for x in f.read().split()]
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
            print(f"terminated {pid}")
        except ProcessLookupError:
            print(f"{pid} already gone")
    os.remove(pidfile)


def cmd_interactive(args):
    """mapping_GUI.py role: a terminal menu over the same commands."""
    # the interactive subparser only defines --session; seed every attribute
    # the dispatched handlers read with the subcommand defaults
    defaults = dict(map_name="ProjectName-LocationName", activate="y", mode="fast",
                    data_dir="", synthetic=64, run=False, device="cuda", name="jueying",
                    session=getattr(args, "session", ""), label=0, lidar_type="")
    for k, v in defaults.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    while True:
        print("\n[1] start mapping  [2] save map  [3] set floor label  "
              "[4] register conf  [5] stop  [q] quit")
        choice = input("> ").strip()
        if choice == "q":
            return
        try:
            if choice == "1":
                args.map_name = input("map name [ProjectName-LocationName]: ").strip() or "ProjectName-LocationName"
                args.activate = input("activate new map (y/n) [y]: ").strip() or "y"
                args.mode = input("mode (fast/indoor/outdoor) [fast]: ").strip() or "fast"
                cmd_start(args)
            elif choice == "2":
                args.name = input("map name [jueying]: ").strip() or "jueying"
                cmd_save_map(args)
            elif choice == "3":
                args.label = int(input("floor label: ").strip())
                cmd_set_floor_label(args)
            elif choice == "4":
                cmd_register_conf(args)
            elif choice == "5":
                cmd_stop(args)
        except (SystemExit, ValueError) as e:
            print(e)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.environ.get("POINTCLOUD_SLAM_ROOT", os.path.expanduser("~/jy_cog")),
                   help="deployment root (the reference's /home/ysc/jy_cog)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("start", help="mapping.sh: new map session")
    s.add_argument("map_name", nargs="?", default="ProjectName-LocationName")
    s.add_argument("--activate", default="y", help="y: activate as system map (validate param)")
    s.add_argument("--mode", default="fast", choices=("fast", "indoor", "outdoor"))
    s.add_argument("--data_dir", default="", help="dataset to replay")
    s.add_argument("--synthetic", type=int, default=64, help="synthetic frame count when no data_dir")
    s.add_argument("--run", action="store_true", help="actually launch the pipeline (else print)")
    s.add_argument("--device", default="cuda", help="torch device the launched apps run on")
    s.set_defaults(fn=cmd_start)

    s = sub.add_parser("save-map", help="save_map.sh: occupancy grid -> system map")
    s.add_argument("--name", default="jueying")
    s.add_argument("--session", default="")
    s.set_defaults(fn=cmd_save_map)

    s = sub.add_parser("pub-occ-map", help="pub_occ_map.sh: validate + re-publish the occupancy map")
    s.add_argument("--name", default="jueying")
    s.add_argument("--session", default="")
    s.set_defaults(fn=cmd_pub_occ_map)

    s = sub.add_parser("set-floor-label", help="set_floor_label.sh")
    s.add_argument("label", type=int)
    s.add_argument("--session", default="")
    s.set_defaults(fn=cmd_set_floor_label)

    s = sub.add_parser("register-conf", help="register_conf.sh")
    s.add_argument("--lidar_type", default="", help="override <root>/system/conf/lidar_type")
    s.set_defaults(fn=cmd_register_conf)

    s = sub.add_parser("stop", help="*_stop.sh: stop recorded session processes")
    s.add_argument("--session", default="")
    s.set_defaults(fn=cmd_stop)

    s = sub.add_parser("interactive", help="mapping_GUI.py role (terminal menu)")
    s.add_argument("--session", default="")
    s.set_defaults(fn=cmd_interactive)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
