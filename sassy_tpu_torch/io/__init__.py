"""FASTA/FASTQ input and output of the port's command line."""
