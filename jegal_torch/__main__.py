"""`python -m jegal_torch <subcommand>`: the port's CLI (cli/main.py)."""
from jegal_torch.cli.main import main

if __name__ == "__main__":
    main()
