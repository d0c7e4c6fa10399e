"""The benchmark's plain reference: PageRank and personalized PageRank
written with plain PyTorch operations from the arcs alone. It imports
nothing of ``repro_torch`` and takes nothing the program made: it works
out the degrees, the teleport vectors and the iterations again."""
