"""DDPG entry of the port.

Counterpart of the repository's `main_ddpg.py` (reference:
libs/ddpg/main_ddpg.py): by default the Pendulum demo; with `--channel`
the on-device DDPG loop on the turbulent channel
(`control.ddpg.train_ddpg_channel_on_device`), whose actor is saved as a
torch checkpoint (`training/checkpoint.py`) for the `ddpg` drag row
(`tools/drag_rows.py --ddpg`).

    python -m pde_policylearning_torch.main_ddpg            # Pendulum
    python -m pde_policylearning_torch.main_ddpg --channel [--device cpu]

It runs on the card unless `--device` names another.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--channel", action="store_true",
                    help="train on the channel DNS (on-device loop)")
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--n_steps", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="./outputs/ddpg_channel_actor.pt")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from .utils import resolve_device
    device = resolve_device(args.device)
    if not args.channel:
        from .control.ddpg import train_pendulum
        return train_pendulum(episodes=args.episodes, device=device)

    from .control.ddpg import train_ddpg_channel_on_device
    from .training import save_checkpoint
    actor, metrics = train_ddpg_channel_on_device(
        n_steps=args.n_steps, warmup=args.warmup, seed=args.seed,
        device=device)
    save_checkpoint(args.out, actor)
    print(f"Actor saved at {args.out}")
    base = metrics["warmup_shear"].mean()
    tail = metrics["shear"][-max(1, args.n_steps // 4):].mean()
    print(f"warmup mean shear {base:.6e} -> last-quarter mean {tail:.6e} "
          f"({100 * (tail - base) / base:+.2f}%)")
    return actor, metrics


if __name__ == "__main__":
    main()
