"""The datagen CLI (counterpart of ``aonerf.data.datagen.generate``).

The reference renders articulated URDF objects with the SAPIEN simulator
(datagen/data_gen.py, data_utils.py) into rgb (alpha = seg mask) / depth /
seg / transforms.json, 100/50/50 random poses on a radius-4 +- 0.5 sphere.
With the ``sapien`` package importable and a ``urdf_file`` (or
``urdf_files``) in the config, this CLI renders through the simulator
(``sapien_backend``); otherwise through the analytic articulated laptop
(``aonerf_torch.data.synthetic``), which writes the same layout.

Usage: python -m aonerf_torch.data.datagen.generate --config gen.json
Config keys: out_dir, mode ('single' | 'multi' | 'replay'), img_wh; single:
n_train, n_val, n_test, articulation_deg, seed, write_depth; multi:
n_instances, degrees, n_images, seed, val_degrees (a list, or "default" for
the held-out midpoints 5..85), n_val_images; replay: transforms (a saved
transforms.json), split, articulation_deg, instance_seed, write_depth;
urdf_file / urdf_files for the simulator. It prints one JSON line,
{"out_dir": ..., "backend": "sapien" | "synthetic"}.
"""

import argparse
import json


def have_sapien() -> bool:
    try:
        import sapien  # noqa: F401

        return True
    except ImportError:
        return False


def generate_with_sapien(cfg: dict) -> str:
    """Generation through the simulator (data_gen.py:34-87), by ``mode``:
    single (the default), multi (needs ``urdf_files``), replay (needs
    ``render_pose_path``). See ``sapien_backend``."""
    from aonerf_torch.data.datagen import sapien_backend as sb

    mode = cfg.get("mode", "single")
    if mode == "replay":
        return sb.replay_sapien_scene(cfg)
    if mode == "multi":
        return sb.generate_sapien_multi(cfg)
    return sb.generate_sapien_scene(cfg)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, required=True)
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)

    if have_sapien() and (cfg.get("urdf_file") or cfg.get("urdf_files")):
        generate_with_sapien(cfg)
        print(json.dumps({"out_dir": cfg["out_dir"], "backend": "sapien"}))
        return

    from aonerf_torch.data.synthetic import generate_multi_scene, generate_single_scene, replay_scene

    img_wh = tuple(cfg.get("img_wh", (320, 240)))
    mode = cfg.get("mode", "single")
    if mode == "replay":
        # re-render at the c2w poses of an existing transforms.json (the
        # reference's saved-pose replay, data_utils.py:244-288)
        replay_scene(
            cfg["out_dir"],
            transforms_path=cfg["transforms"],
            split=cfg.get("split", "replay"),
            img_wh=img_wh,
            articulation_deg=cfg.get("articulation_deg", 80.0),
            instance_seed=cfg.get("instance_seed", 0),
            write_depth=cfg.get("write_depth", False),
        )
    elif mode == "multi":
        from aonerf_torch.data.sapien_multi import DEFAULT_VAL_DEGREES

        val_degrees = cfg.get("val_degrees", ())
        if val_degrees == "default":
            val_degrees = DEFAULT_VAL_DEGREES
        generate_multi_scene(
            cfg["out_dir"],
            img_wh=img_wh,
            n_instances=cfg.get("n_instances", 2),
            degrees=tuple(cfg.get("degrees", range(0, 100, 10))),
            n_images=cfg.get("n_images", 60),
            seed=cfg.get("seed", 0),
            val_degrees=tuple(val_degrees),
            n_val_images=cfg.get("n_val_images", 0),
        )
    else:
        generate_single_scene(
            cfg["out_dir"],
            img_wh=img_wh,
            n_train=cfg.get("n_train", 100),
            n_val=cfg.get("n_val", 50),
            n_test=cfg.get("n_test", 50),
            articulation_deg=cfg.get("articulation_deg", 80.0),
            seed=cfg.get("seed", 0),
            write_depth=cfg.get("write_depth", False),
        )
    print(json.dumps({"out_dir": cfg["out_dir"], "backend": "sapien" if have_sapien() else "synthetic"}))


if __name__ == "__main__":
    main()
