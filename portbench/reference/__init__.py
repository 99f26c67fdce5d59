"""The benchmark's decks and its plain reference solver; nothing here
imports the program."""
