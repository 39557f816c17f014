"""``python -m bart_tpu_torch -c <cfg>``: the retrieval pipeline's CLI."""

from bart_tpu_torch.driver.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
