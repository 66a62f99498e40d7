"""`python -m jegal_torch.cli` == `python -m jegal_torch`."""
from jegal_torch.cli.main import main

if __name__ == "__main__":
    main()
