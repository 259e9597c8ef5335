"""The plain reference that decides `correct`.

Plain PyTorch (any device) and NumPy, written for this benchmark: it
imports nothing of the program under test nor of the JAX package, and
takes only the libraries the harness made.  It counts the libraries'
canonical (k+1)-mers again (kmers.py), builds the unitig graph of the
kept ones (unitigs.py), indexes that graph's minimizers and maps every
read with the vote, the gapless bound and the affine-gap DP (mapper.py,
dp.py); compare.py holds the program's outputs against it.
"""
