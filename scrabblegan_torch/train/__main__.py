import sys

from scrabblegan_torch.train.cli import main

sys.exit(main())
