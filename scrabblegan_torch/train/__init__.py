"""Training in the port: optimizers, train state, the four-network step,
checkpoints, the serving bundle (`export`), the epoch Trainer (`loop`) and
its entry point (`python -m scrabblegan_torch.train`, `main`).

`main` imports the CLI when called, so that importing a module of this
package (the bundle loader in `export`) does not import the model code."""


def main(argv=None) -> int:
    from scrabblegan_torch.train.cli import main as cli_main

    return cli_main(argv)


__all__ = ["main"]
