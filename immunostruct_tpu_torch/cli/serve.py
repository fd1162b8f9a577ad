"""CLI entry for batch serving (``python -m immunostruct_tpu_torch.cli.serve``).

Thin wrapper over ``immunostruct_tpu_torch.serving``; see that module for
the transports and the request format.
"""

from immunostruct_tpu_torch.serving import main

if __name__ == "__main__":
    main()
